"""The mesh prover (parallel/mesh.py) and prove_core's shard over real process
groups: 2 and 4 gloo processes on the CPU, spawned, meeting through a file
store in the test's directory (no TCP port to collide between test workers),
one thread each, every wait bounded.  The demo circuit's B=2 proof on the grids
(dp 2, col 1), (dp 1, col 2), (dp 2, col 2) and (dcn 2, dp 1, col 2) equals
the port's single-device proof and the reference's numpy proof leaf for leaf
(tolerance 0), on every rank, and the reference's numpy verifier accepts it;
a sharded commit whose column count the shards do not divide equals the
reference's; a batch that does not divide over the batch axes raises, and so
does a col axis of 3 ranks, which does not divide the LDE domain.  This
stands in for the reference's tests/test_parallel.py, which needs eight XLA
devices.  The reference package is imported inside the fixtures: the spawned
ranks import this module and nothing of it."""

import datetime
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.circuit.recursive_verifier import split_proof_lanes
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.parallel import mesh
from plonky2_ecdsa_tpu_torch.prover import fri_cuda, prover, serialize
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

BATCH = 2
TIMEOUT_S = 120          # the process group's and the join's bound
# name -> (dcn or None, dp, col, entry): entry "vals" proves the value table
# through run.run_vals, "witness" the full witness through run, "raises"
# expects make_mesh_prover to refuse the grid
GRIDS = {2: {"dp2_col1": (None, 2, 1, "vals"), "dp1_col2": (None, 1, 2, "witness")},
         3: {"dp1_col3": (None, 1, 3, "raises"), "dcn1_dp1_col3": (1, 1, 3, "raises")},
         4: {"dp2_col2": (None, 2, 2, "witness"), "dcn2_dp1_col2": (2, 1, 2, "vals")}}
PROVING = [(w, g) for w in GRIDS for g, spec in GRIDS[w].items() if spec[3] != "raises"]
ODD_COLS = 5             # a column count that 2 shards do not divide


def _odd_vals():
    rng = np.random.default_rng(21)
    return rng.integers(0, gl.P, (BATCH, ODD_COLS, 8), dtype=np.uint64)


def _rank(rank: int, world: int, tmp: str):
    """One rank: every grid of its world size on the demo circuit; results to
    files in tmp.  DOMAIN_CHUNK = PLAIN_CHUNK = 8: each rank's domain slice
    (N/ns = 16 or 8 points) runs in more than one chunk where it can."""
    torch.set_num_threads(1)
    prover.DOMAIN_CHUNK = fri_cuda.PLAIN_CHUNK = 8
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        data = serialize.load_circuit_data(os.path.join(tmp, "data.npz"), "cpu")
        with np.load(os.path.join(tmp, "inputs.npz")) as z:
            W, vals, pis = z["W"], z["vals"], z["pis"]
        for name, (dcn, dp, col, entry) in GRIDS[world].items():
            m = (mesh.prover_mesh(col_parallel=col, device_type="cpu") if dcn is None else
                 mesh.prover_mesh_2level(dcn, dp * col, col_parallel=col, device_type="cpu"))
            assert m.mesh_dim_names == (("dp", "col") if dcn is None else ("dcn", "dp", "col"))
            assert tuple(m.shape) == ((dp, col) if dcn is None else (dcn, dp, col))
            if entry == "raises":
                try:
                    mesh.make_mesh_prover(data, m)
                except ValueError as e:
                    with open(os.path.join(tmp, f"{name}_{rank}.raised"), "w") as f:
                        f.write(str(e))
                continue
            run = mesh.make_mesh_prover(data, m)
            proof = run.run_vals(vals, pis) if entry == "vals" else run(W, pis)
            serialize.save_proof(proof, os.path.join(tmp, f"{name}_{rank}.npz"))
            if dp * (dcn or 1) > 1:
                try:
                    run(W[..., :1], pis[:1])
                except ValueError:
                    open(os.path.join(tmp, f"{name}_{rank}.raised"), "w").close()
            if col == 2 and world == 2:
                shard = (m.get_group("col"), col)
                coeffs, lde, tree = prover._lde_commit_sharded(
                    gl.from_u64(_odd_vals()), data.N, 1, shard)
                np.savez(os.path.join(tmp, f"odd_{rank}.npz"), coeffs=gl.to_u64(coeffs),
                         lde=gl.to_u64(lde), cap=gl.to_u64(tree.cap))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, tmp: str):
    """Run _rank on `world` spawned processes; fail on a nonzero exit, or on
    any process still running after TIMEOUT_S (which is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, tmp)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    assert not hung, f"ranks {hung} of {world} still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The port's demo circuit data (saved for the ranks), its inputs, its
    single-device proof; the reference's data and numpy proof."""
    from plonky2_ecdsa_tpu.circuit import examples as ref_examples
    from plonky2_ecdsa_tpu.prover import data as ref_data_mod
    from plonky2_ecdsa_tpu.prover import prover as ref_prover

    tmp = tmp_path_factory.mktemp("mesh")
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, BATCH)
    rng = np.random.default_rng(42 + BATCH)          # small_demo_witness's inputs
    xs = rng.integers(0, 1 << 29, size=(BATCH, 1), dtype=np.uint64)
    ys = rng.integers(0, gl.P, size=(BATCH, 1), dtype=np.uint64) % np.uint64(gl.P)
    vals = c.value_table({"x": xs, "y": ys}, BATCH)
    assert np.array_equal(c.public_input_values(), pis)
    serialize.save_circuit_data(data, str(tmp / "data.npz"))
    np.savez(tmp / "inputs.npz", W=W, vals=vals, pis=pis)
    single = prover.prove(data, W, pis)

    mp = pytest.MonkeyPatch()
    mp.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    try:
        ref_c = ref_examples.small_demo_circuit().build()
        ref_data = ref_data_mod.build_circuit_data(ref_c)
    finally:
        mp.undo()
    ref_W, ref_pis = ref_examples.small_demo_witness(ref_c, batch=BATCH)
    ref = ref_prover.prove(ref_data, ref_W, ref_pis)
    return dict(tmp=str(tmp), data=data, single=single, ref=ref, ref_data=ref_data)


@pytest.fixture(scope="module")
def world2(demo):
    _spawn(2, demo["tmp"])
    return demo


@pytest.fixture(scope="module")
def world3(demo):
    _spawn(3, demo["tmp"])
    return demo


@pytest.fixture(scope="module")
def world4(demo):
    _spawn(4, demo["tmp"])
    return demo


@pytest.mark.parametrize("world,grid", PROVING)
def test_mesh_proof_equals_single_device_and_reference(world, grid, request):
    from plonky2_ecdsa_tpu.prover.verifier import verify as ref_verify
    from test_torch_bridge import from_reference_proof, to_reference_proof

    d = request.getfixturevalue(f"world{world}")
    ref = from_reference_proof(d["ref"])
    assert prover.first_difference(ref, d["single"]) is None
    for rank in range(world):
        got = serialize.load_proof(os.path.join(d["tmp"], f"{grid}_{rank}.npz"))
        assert prover.first_difference(d["single"], got) is None, (grid, rank)
        assert prover.first_difference(ref, got) is None, (grid, rank)
    assert ref_verify(d["ref_data"], to_reference_proof(got))


def test_sharded_commit_with_columns_the_shards_do_not_divide(world2):
    """k % ns != 0: the columns stay whole on every rank and only the leaf
    hashing is split; the same coefficients, LDE and cap as the port's and
    the reference's single-device commits."""
    from plonky2_ecdsa_tpu.prover import prover as ref_prover
    from test_torch_bridge import pair_to_u64, u64_to_pair

    N = world2["data"].N
    vals = _odd_vals()
    coeffs, lde, tree = prover._lde_commit(gl.from_u64(vals), N, 1)
    (rc, rh), rl, rtree = ref_prover._lde_commit(u64_to_pair(vals), 8, N, 1, np)
    assert np.array_equal(gl.to_u64(coeffs), pair_to_u64((rc, rh)))
    assert np.array_equal(gl.to_u64(lde), pair_to_u64(rl))
    assert np.array_equal(gl.to_u64(tree.cap), pair_to_u64(rtree.cap))
    for rank in range(2):
        with np.load(os.path.join(world2["tmp"], f"odd_{rank}.npz")) as z:
            assert np.array_equal(z["coeffs"], gl.to_u64(coeffs))
            assert np.array_equal(z["lde"], gl.to_u64(lde))
            assert np.array_equal(z["cap"], gl.to_u64(tree.cap))


@pytest.mark.parametrize("world,grid", [(2, "dp2_col1"), (4, "dp2_col2"), (4, "dcn2_dp1_col2")])
def test_batch_that_does_not_divide_raises(world, grid, request):
    d = request.getfixturevalue(f"world{world}")
    for rank in range(world):
        assert os.path.exists(os.path.join(d["tmp"], f"{grid}_{rank}.raised")), (grid, rank)


@pytest.mark.parametrize("grid", list(GRIDS[3]))
def test_col_axis_that_does_not_divide_the_domain_raises(grid, world3):
    """col 3 divides the 3 ranks, so the mesh keeps it, but not the LDE
    domain (a power of two): make_mesh_prover refuses it on every rank
    instead of leaving the last N % 3 points unhashed."""
    assert world3["data"].N % 3
    for rank in range(3):
        with open(os.path.join(world3["tmp"], f"{grid}_{rank}.raised")) as f:
            assert "must divide over the col axis (3 ranks)" in f.read(), (grid, rank)


def test_mesh_needs_a_process_group(demo):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.prover_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.prover_mesh_2level(2, 2, device_type="cpu")


def test_join_proof_lanes_inverts_a_lane_split(demo):
    single = demo["single"]
    lanes = split_proof_lanes(single, BATCH)         # B = 2: lane i is block i
    assert prover.proof_digest(lanes[1]) != prover.proof_digest(lanes[0])
    assert prover.first_difference(mesh.join_proof_lanes(lanes), single) is None
