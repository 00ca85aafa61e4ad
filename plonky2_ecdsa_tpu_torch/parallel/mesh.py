"""Device-mesh sharding of the batched prover over torch.distributed.

Counterpart of ``plonky2_ecdsa_tpu.parallel.mesh``.  One process is one rank
and one rank is one device; the caller initializes the process group
(``torch.distributed.init_process_group``: NCCL between cards, gloo on the CPU
or for ranks that share a card) and sets each rank's current CUDA device.  The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank, with
the reference's axes:

  * ``dp``  - the signature batch: each rank proves its own lanes, with no
    communication;
  * ``col`` - the columns and the LDE domain inside one proof: ``prove_core``'s
    ``shard`` splits the commits' transforms by column and the leaf sponge, the
    quotient and the FRI reduced polynomial by domain, with an all_gather at
    the end of each; the rest runs replicated on every rank of the axis;
  * ``dcn`` (``prover_mesh_2level``) - a second batch axis, across hosts,
    outermost, so that the col axis's gathers stay inside a host.

Every rank calls ``run`` with the whole batch and gets the whole proof back:
the lanes are joined in rank order over the batch axes (dcn, dp).  Without an
initialized process group the functions here raise; nothing falls back to one
device.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..prover import fri
from ..prover.data import CircuitData
from ..prover.prover import Proof, Prover


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("mesh: no torch.distributed process group is initialized "
                           "(call torch.distributed.init_process_group on every rank first)")
    return dist.get_world_size()


def _col_size(col_parallel: int, devices: int) -> int:
    """col_parallel where it divides the devices, else 1 (pure batch
    parallelism), as the reference's mesh has it."""
    return col_parallel if col_parallel > 0 and devices % col_parallel == 0 else 1


def prover_mesh(n_devices: int | None = None, col_parallel: int = 2,
                device_type: str = "cuda") -> DeviceMesh:
    """2-D (dp, col) mesh over every rank of the process group (n_devices,
    where given, must be the world size)."""
    n = _world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"mesh: {n_devices} devices asked for, the process group has {n} ranks")
    col = _col_size(col_parallel, n)
    return init_device_mesh(device_type, (n // col, col), mesh_dim_names=("dp", "col"))


def prover_mesh_2level(n_hosts: int, chips_per_host: int, col_parallel: int = 2,
                       device_type: str = "cuda") -> DeviceMesh:
    """3-D (dcn, dp, col) mesh: the batch over hosts and over the devices of a
    host, the communicating col axis inside a host (ranks of one host are
    consecutive)."""
    need = n_hosts * chips_per_host
    if _world_size() != need:
        raise ValueError(f"mesh: {n_hosts} x {chips_per_host} devices asked for, the process "
                         f"group has {dist.get_world_size()} ranks")
    col = _col_size(col_parallel, chips_per_host)
    return init_device_mesh(device_type, (n_hosts, chips_per_host // col, col),
                            mesh_dim_names=("dcn", "dp", "col"))


def _join(parts):
    """The same nesting of arrays from every lane block -> one nesting, each
    array joined on its lane axis (axis 0)."""
    first = parts[0]
    if isinstance(first, tuple):
        return tuple(_join([p[i] for p in parts]) for i in range(len(first)))
    if isinstance(first, list):
        return [_join([p[i] for p in parts]) for i in range(len(first))]
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts]) for k in first}
    return None if first is None else np.concatenate(parts, 0)


def join_proof_lanes(parts: list) -> Proof:
    """Host Proofs of consecutive lane blocks, in order -> one Proof of all
    the lanes (the inverse of a contiguous lane split)."""
    fps = [p.fri_proof for p in parts]
    return Proof(**{k: _join([getattr(p, k) for p in parts])
                    for k in vars(parts[0]) if k not in ("fri_proof", "layout")},
                 fri_proof=fri.FriProof(**{k: _join([getattr(fp, k) for fp in fps])
                                          for k in vars(fps[0])}),
                 layout=parts[0].layout)


def make_mesh_prover(data: CircuitData, mesh: DeviceMesh):
    """The prover of `data` on this rank of `mesh`: the batch over every
    non-col axis, the columns and domain over 'col' (prove_core's shard).
    `data` lives on this rank's device.  Returns run(W, pis) -> Proof, with
    run.run_vals(vals, pis) -> Proof the production input (the tape's value
    table [T, B]); every rank passes the whole batch and gets the whole host
    Proof back.  The batch must divide over the batch axes, and the LDE
    domain over the col axis."""
    if data.device.type != mesh.device_type:
        raise ValueError(f"mesh: the circuit data is on {data.device}, the mesh is "
                         f"{mesh.device_type}")
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    batch_axes = [a for a in names if a != "col"]
    parts, part = 1, 0
    for a in batch_axes:                       # this rank's lane block, row-major over (dcn, dp)
        parts, part = parts * sizes[a], part * sizes[a] + coord[a]
    ncol = sizes.get("col", 1)
    if data.N % ncol:
        raise ValueError(f"mesh: the LDE domain of {data.N} points must divide over the "
                         f"col axis ({ncol} ranks)")
    shard = (mesh.get_group("col"), ncol) if ncol > 1 else None
    replica = coord.get("col", 0)
    prover = Prover(data, shard=shard)

    def lanes(B: int) -> slice:
        if B % parts:
            raise ValueError(f"mesh: batch {B} must divide over the batch axes "
                             f"{batch_axes} ({parts} parts)")
        per = B // parts
        return slice(part * per, (part + 1) * per)

    def gathered(proof: Proof) -> Proof:
        """This rank's lanes -> every lane, from the col-0 rank of each part
        (collect has checked each part's grind)."""
        blocks = [None] * dist.get_world_size()
        dist.all_gather_object(blocks, (part, proof) if replica == 0 else None)
        return join_proof_lanes([p for _part, p in sorted((b for b in blocks if b is not None),
                                                         key=lambda b: b[0])])

    def run(W: np.ndarray, pis: np.ndarray) -> Proof:
        sl = lanes(W.shape[-1])
        handle = prover.dispatch(np.ascontiguousarray(W[..., sl]), pis[sl])
        return gathered(prover.collect(handle))

    def run_vals(vals: np.ndarray, pis: np.ndarray) -> Proof:
        sl = lanes(vals.shape[1])
        return gathered(prover.run_vals(np.ascontiguousarray(vals[:, sl]), pis[sl]))

    run.run_vals = run_vals
    return run
