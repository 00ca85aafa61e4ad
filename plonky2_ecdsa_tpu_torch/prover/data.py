"""Per-circuit fixed data on the device.

Counterpart of the reference's ``prover.prover.Backend`` (prover.py:154).
``build_circuit_data`` runs the reference's host build (a numpy fixed
commit) with its device switch held off, so that it never imports JAX;
``backend_from_circuit_data`` then turns the reference's ``CircuitData``
numpy arrays into int64 tensors on the prover's device.
"""

from __future__ import annotations

import os

import torch

from plonky2_ecdsa_tpu.prover import data as _ref
from plonky2_ecdsa_tpu.prover import fri as _ref_fri

from ..fields import goldilocks as gl
from . import ntt, ntt_cuda

_HOST_BUILD = "PLONKY2_TPU_HOST_BUILD"


def build_circuit_data(circuit) -> _ref.CircuitData:
    """The reference's build_circuit_data on the host, never touching JAX."""
    old = os.environ.get(_HOST_BUILD)
    os.environ[_HOST_BUILD] = "1"
    try:
        return _ref.build_circuit_data(circuit)
    finally:
        if old is None:
            del os.environ[_HOST_BUILD]
        else:
            os.environ[_HOST_BUILD] = old


def as_device(device) -> torch.device:
    """A torch.device with its index filled in (tables are cached by device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Backend:
    """The circuit's fixed data as int64 tensors on one device."""

    def __init__(self, data: _ref.CircuitData, device):
        self.device = device = as_device(device)
        circuit = data.circuit
        cfg = circuit.config
        nc, S, nr = cfg.num_constant_cols, len(circuit.gates), cfg.num_routed_wires
        self.fixed_lde = gl.from_pair(*data.fixed_lde, device)          # [F0, N]
        self.fixed_coeffs = gl.from_pair(*data.fixed_coeffs, device)    # [F0, n]
        self.fixed_levels = [gl.from_pair(*lv, device) for lv in data.fixed_tree.levels]
        self.fixed_cap_height = data.fixed_tree.cap_height
        self.ids = gl.from_u64(data.id_encodings, device)               # [nr, n]
        self.sig = gl.from_u64(data.fixed_values[nc + S:nc + S + nr], device)
        self.x = gl.from_u64(data.x_lde, device)                        # [N]
        self.zh_inv = gl.from_pair(*data.zh_inv, device)
        self.l0_lde = gl.from_pair(*data.l0_lde, device)
        self.k_coeffs = gl.from_ints(circuit.k_coeffs, device)          # [nr]
        _warm_tables(data, device)


def _warm_tables(data, device):
    """Build the NTT and FRI tables the prover will look up, at set-up."""
    _nl, final_size, _nf = _ref_fri.plan(data.N, data.circuit.config)
    for n in {data.n, data.N, final_size}:
        ntt.coset_powers(n, False, device)
        ntt.coset_powers(n, True, device)
        sizes = ntt._ref._split2(n) if n >= ntt.FOUR_STEP_MIN else (n,)
        for inverse in (False, True):
            for n_t in sizes:
                ntt_cuda.twiddles(n_t, inverse, device)
            if n >= ntt.FOUR_STEP_MIN:
                ntt_cuda.four_step_T(n, inverse, device)


def backend_from_circuit_data(data: _ref.CircuitData, device) -> Backend:
    return Backend(data, device)
