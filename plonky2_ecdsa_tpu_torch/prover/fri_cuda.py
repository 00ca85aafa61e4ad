"""FRI's DEEP-reduced polynomial as one CUDA pass (``csrc/fri.cu``).

The JAX package has no kernel here: its reduction
(``plonky2_ecdsa_tpu/prover/prover.py:1406``) is jnp that XLA fuses.  For
each lane b and point x_j of a domain slice, ``reduced_poly`` computes

    F(x_j) = (sum_t a^t p_t(x_j) - y) / (x_j - zeta)
           + a^T (sum_k a^k z_k(x_j) - y') / (x_j - g zeta)

over the quadratic extension, y = sum_t a^t open0_t, y' = sum_k a^k
open1_k, the p_t the rows of the fixed, wires, zs and quotient LDEs in that
order (T of them) and z_k zs row ``z_rows[k]``.  Eagerly that was two
Fermat ladders a point, a [B, T, m] copy of the sources and ~45 int64
kernels a field multiply; the kernel reads each LDE word once where it
lies, the fixed rows shared by the lanes.

For CPU tensors the wrapper takes ``reduced_poly_plain`` (``fields/goldilocks.py``,
the prover's former eager code, PLAIN_CHUNK points at a time); for CUDA
tensors it launches the kernel once over the slice, or raises.  Either way
the arguments are checked first (``reduced_plan``, which also says what the
kernel is handed).  ``launches`` counts the kernel's launches, ``replayed``
its launches by replays of a captured prove (``prover/graph.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields import goldilocks as gl
from . import ntt

THREADS = 256            # csrc/fri.cu's: a block's threads,
V = 2                    # points a thread,
TILE = THREADS * V       # points a block,
MAX_Z = 16               # rows of the second sum,
MAX_TERMS = 2048         # rows of the first,
MAX_WORDS = 1 << 31      # and B m below 2^31
SOURCES = ("fixed", "wires", "zs", "quotient")
PLAIN_CHUNK = 1 << 14    # points reduced_poly_plain takes at a time (its [B, T, m] stack)

_LL = ctypes.c_longlong


class _Mat(ctypes.Structure):
    """csrc/fri.cu's Mat: words at ptr + b lane + i col (+ j)."""
    _fields_ = [("ptr", ctypes.c_void_p), ("lane", _LL), ("col", _LL), ("rows", _LL)]


class _Args(ctypes.Structure):
    """csrc/fri.cu's Args (every field 8 bytes: the layouts agree)."""
    _fields_ = [("src", _Mat * 4), ("x", _Mat), ("zeta", _Mat * 2), ("gzeta", _Mat * 2),
                ("alpha", _Mat * 2), ("open0", _Mat * 2), ("open1", _Mat * 2),
                ("out", ctypes.c_void_p), ("B", _LL), ("m", _LL), ("K", _LL),
                ("zrows", _LL * MAX_Z)]


def reduced_plan(x, sources, z_rows, zeta, gzeta, alpha, open0, open1) -> dict:
    """What fri_reduced is handed, after the checks: B, m, T, K, z_rows and
    the blocks; `src`, the four sources as (tensor, lane stride, row stride,
    rows), the fixed one's lane stride 0; x as (tensor, 0, 1); the per-lane
    values and the openings as (tensor, lane stride, column stride) per
    component.  Raises on what the kernel does not take: other than int64
    tensors on one device, sources whose shapes disagree, 2^31 points of all
    lanes or more, points that are not adjacent words, z_rows outside zs,
    more rows than MAX_TERMS and MAX_Z, openings of other shapes."""
    if not (isinstance(sources, tuple) and len(sources) == 4):
        raise TypeError(f"reduced_poly: sources must be the four LDEs {SOURCES}")
    exts = {"zeta": zeta, "gzeta": gzeta, "alpha": alpha, "open0": open0, "open1": open1}
    for name, e in exts.items():
        if not (isinstance(e, tuple) and len(e) == 2):
            raise TypeError(f"reduced_poly: {name} must be an extension pair of tensors")
    tensors = [x, *sources, *(c for e in exts.values() for c in e)]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("reduced_poly: takes int64 tensors")
    _build.check_tensors("reduced_poly", *tensors, contiguous=False)
    fixed, wires, zs, quot = sources
    if x.dim() != 1 or fixed.dim() != 2 or any(s.dim() != 3 for s in sources[1:]):
        raise ValueError(f"reduced_poly: needs x [m], fixed [rows, m] and [B, rows, m] LDEs, got "
                         f"{[tuple(t.shape) for t in (x, *sources)]}")
    B, m = wires.shape[0], x.shape[0]
    if any(s.shape[-1] != m for s in sources) or any(s.shape[0] != B for s in sources[1:]):
        raise ValueError(f"reduced_poly: sources {[tuple(s.shape) for s in sources]} do not "
                         f"share B = {B} lanes and the {m} points of x")
    if B * m >= MAX_WORDS:
        raise ValueError(f"reduced_poly: {B} x {m} points; the kernel takes fewer than 2^31")
    if m > 1 and any(t.stride(-1) != 1 for t in (x, *sources)):
        raise ValueError("reduced_poly: the points of x and of each source must be adjacent words")
    rows = [s.shape[-2] for s in sources]
    T = sum(rows)
    z_rows = [int(r) for r in z_rows]
    K = len(z_rows)
    if T > MAX_TERMS or K > MAX_Z:
        raise ValueError(f"reduced_poly: {T} rows and {K} second rows; the kernel takes at most "
                         f"{MAX_TERMS} and {MAX_Z}")
    if any(not 0 <= r < rows[2] for r in z_rows):
        raise ValueError(f"reduced_poly: z_rows {z_rows} outside zs's {rows[2]} rows")
    shapes = {"zeta": (B,), "gzeta": (B,), "alpha": (B,), "open0": (B, T), "open1": (B, K)}
    for name, e in exts.items():
        if any(tuple(c.shape) != shapes[name] for c in e):
            raise ValueError(f"reduced_poly: {name} has components of shapes "
                             f"{[tuple(c.shape) for c in e]}, not {shapes[name]}")
    src = [(fixed, 0, fixed.stride(0), rows[0])]
    src += [(s, s.stride(0), s.stride(1), r) for s, r in zip(sources[1:], rows[1:])]
    per_lane = {name: [(c, c.stride(0), 0 if c.dim() == 1 else c.stride(1)) for c in e]
                for name, e in exts.items()}
    return dict(B=B, m=m, T=T, K=K, z_rows=z_rows, src=src, x=(x, 0, 1), **per_lane,
                blocks=B * -(-m // TILE))


def _args(plan: dict, out) -> _Args:
    def mat(t, lane, col, rows=0):
        return _Mat(t.data_ptr(), lane, col, rows)

    a = _Args()
    for i, s in enumerate(plan["src"]):
        a.src[i] = mat(*s)
    a.x = mat(*plan["x"])
    for name in ("zeta", "gzeta", "alpha", "open0", "open1"):
        for i, c in enumerate(plan[name]):
            getattr(a, name)[i] = mat(*c)
    a.out, a.B, a.m, a.K = out.data_ptr(), plan["B"], plan["m"], plan["K"]
    for i, r in enumerate(plan["z_rows"]):
        a.zrows[i] = r
    return a


def reduced_poly(x, sources, z_rows, zeta, gzeta, alpha, open0, open1) -> tuple:
    """The reduced polynomial at the slice's points -> extension pair of
    [B, m].  x [m]: the points; sources: the fixed [Tf, m], wires [B, W, m],
    zs [B, Z, m] and quotient [B, Q, m] LDEs at them (views, read in
    place); z_rows: the zs rows of the second sum (Python ints); zeta,
    gzeta, alpha: extension pairs of [B]; open0 [B, T] and open1 [B, K]:
    the openings at zeta and at g zeta."""
    plan = reduced_plan(x, sources, z_rows, zeta, gzeta, alpha, open0, open1)
    if x.device.type == "cpu":
        return reduced_poly_plain(x, sources, z_rows, zeta, gzeta, alpha, open0, open1)
    out = torch.empty((2, plan["B"], plan["m"]), dtype=torch.int64, device=x.device)
    if out.numel():
        args = _args(plan, out)
        with torch.cuda.device(x.device):
            _build.check(_build.library().fri_reduced(ctypes.byref(args),
                                                      _build.stream_ptr(out)), "fri_reduced")
        reduced_poly.launches += 1
    return (out[0], out[1])


def reduced_poly_plain(x, sources, z_rows, zeta, gzeta, alpha, open0, open1) -> tuple:
    """reduced_poly in the eager field of fields/goldilocks.py: two Fermat
    ladders a point and the sources' [B, T, m] stack, PLAIN_CHUNK points at
    a time."""
    fixed, wires, zs, quot = sources
    B = wires.shape[0]
    T = sum(s.shape[-2] for s in sources)
    apows = ntt.ext_powers(alpha, T)                          # ext [B, T]
    apows1 = ntt.ext_powers(alpha, len(z_rows))
    ye = gl.ext_mul(apows, open0)
    y = (gl.sum_mod(ye[0], 1), gl.sum_mod(ye[1], 1))
    ye1 = gl.ext_mul(apows1, open1)
    y1 = (gl.sum_mod(ye1[0], 1), gl.sum_mod(ye1[1], 1))
    apow_T = gl.ext_mul((apows[0][:, -1], apows[1][:, -1]), alpha)

    def bc(e):
        return (e[0][:, None], e[1][:, None])

    def chunk(sl):
        xb = gl.ext_from_base(x[sl].expand(B, -1))
        inv0 = gl.ext_inverse(gl.ext_sub(xb, bc(zeta)))
        inv1 = gl.ext_inverse(gl.ext_sub(xb, bc(gzeta)))
        polys = torch.cat([fixed[None, :, sl].expand(B, -1, -1), wires[..., sl], zs[..., sl],
                           quot[..., sl]], 1)                                 # [B, T, m]
        acc = tuple(gl.sub(gl.sum_mod(gl.mul(polys, apows[i][..., None]), 1), y[i][:, None])
                    for i in range(2))
        F = gl.ext_mul(acc, inv0)
        # stacked views: indexing by a list would upload it
        zp = torch.stack([zs[:, r, sl] for r in z_rows], 1) if z_rows else zs[:, :0, sl]
        acc1 = tuple(gl.sub(gl.sum_mod(gl.mul(zp, apows1[i][..., None]), 1), y1[i][:, None])
                     for i in range(2))
        return gl.ext_add(F, gl.ext_mul(bc(apow_T), gl.ext_mul(acc1, inv1)))

    m = x.shape[0]
    if m <= PLAIN_CHUNK:
        return chunk(slice(None))
    parts = [chunk(slice(s, s + PLAIN_CHUNK)) for s in range(0, m, PLAIN_CHUNK)]
    return tuple(torch.cat(c, -1) for c in zip(*parts))


reduced_poly.launches = 0
reduced_poly.replayed = 0
