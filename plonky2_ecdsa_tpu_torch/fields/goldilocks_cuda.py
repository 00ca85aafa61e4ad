"""The quotient's Goldilocks arithmetic as CUDA kernels (``csrc/field.cu``).

The JAX package has no kernel here (XLA fuses its field arithmetic); eager
PyTorch spells one field operation as ~45 int64 elementwise kernels
(``fields/goldilocks.py``: ``_mulhilo``, ``reduce128``, ``_canon``, ``ult``),
each reading and writing full-size tensors, and that traffic was most of the
prover's quotient.  Each wrapper here is one launch:

  * ``add``, ``sub``, ``mul`` (a, b) and ``neg`` (a): the operands broadcast
    as torch broadcasts them, read in place by their strides, either one a
    Python int instead (a constant: an int64 bit pattern for add and sub, as
    ``goldilocks.add`` takes it; any int, taken mod p, for mul); the result
    a fresh contiguous tensor of the broadcast shape;
  * ``sum_mod`` (x, dim) and ``dot_mod`` (x, w, dim) = sum over `dim` of
    x * w: the weighted product is never written.

Each takes ``fields/goldilocks.py``'s function for CPU tensors; for CUDA
tensors it launches its kernel or raises.  Either way the operands are
checked first: int64, one device, fewer than 2^31 output words, and the
broadcast shape and strides collapsed (``collapse``) to at most four axes.
``binary_plan`` and ``reduce_plan`` say what a kernel is handed.  ``launches`` on each wrapper
counts its kernel launches, ``replayed`` its launches by replays of a
captured prove (``prover/graph.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from . import goldilocks as gl

DIMS = 4                 # csrc/field.cu's DIMS: the axes a kernel walks
MAX_WORDS = 1 << 31      # csrc/field.cu's MAX_WORDS: its slot indices are 32-bit
MASK64 = (1 << 64) - 1
_OPS = {"add": 0, "sub": 1, "mul": 2, "neg": 3}
_Strides = ctypes.c_longlong * (DIMS + 1)


def broadcast_shape(*shapes) -> tuple:
    """torch.broadcast_shapes in plain Python (a tenth of its host time)."""
    out = [1] * max(map(len, shapes))
    for shape in shapes:
        for i, size in enumerate(shape, len(out) - len(shape)):
            if size != 1:
                if out[i] not in (1, size):
                    raise ValueError(f"field kernels: shapes {[tuple(s) for s in shapes]} "
                                     f"do not broadcast")
                out[i] = size
    return tuple(out)


def broadcast_strides(t: torch.Tensor, shape) -> list:
    """t's strides on `shape` (which t broadcasts to): 0 on an axis t lacks
    or holds once."""
    lead = len(shape) - t.dim()
    strides = [0] * len(shape)
    for i, (size, stride) in enumerate(zip(t.shape, t.stride())):
        if size != 1:
            strides[lead + i] = stride
    return strides


def contiguous_strides(shape) -> list:
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= size
    return strides[::-1]


def collapse(shape, strides_list):
    """(sizes, [strides of each list]) over exactly DIMS axes that walk the
    same words as `shape` does with each stride list: axes of size 1
    dropped, each axis merged into the one before it where every list steps
    over the pair as over one axis, then ones put in front.  Raises
    ValueError where more than DIMS axes remain, or `shape` holds MAX_WORDS
    words or more."""
    if math.prod(shape) >= MAX_WORDS:
        raise ValueError(f"field kernels: a shape {tuple(shape)} of {math.prod(shape)} words; "
                         f"the kernels write fewer than 2^31")
    sizes, out = [], [[] for _ in strides_list]
    for i, size in enumerate(shape):
        if size == 1:
            continue
        if sizes and all(st[-1] == s[i] * size for st, s in zip(out, strides_list)):
            sizes[-1] *= size
            for st, s in zip(out, strides_list):
                st[-1] = s[i]
        else:
            sizes.append(size)
            for st, s in zip(out, strides_list):
                st.append(s[i])
    if len(sizes) > DIMS:
        raise ValueError(f"field kernels: a shape {tuple(shape)} with these strides walks "
                         f"{len(sizes)} axes; they take at most {DIMS}")
    pad = DIMS - len(sizes)
    return [1] * pad + sizes, [[0] * pad + st for st in out]


def plan(shape, tensors):
    """(sizes, strides) of an elementwise launch: `shape` and, first, the
    output's contiguous strides, then each tensor's broadcast strides,
    collapsed to DIMS axes."""
    return collapse(shape, [contiguous_strides(shape)]
                    + [broadcast_strides(t, shape) for t in tensors])


def binary_plan(op: str, a, b):
    """(shape, sizes, operands, vec): what gl_binary is handed for `a op b`
    (op add, sub, mul or neg): the output's shape, the sizes of the DIMS
    axes, each operand as (tensor, its strides, 0) or, for a Python int,
    (None, None, its u64 word: mod p for mul, the int64 bit pattern for add
    and sub), and whether a thread takes two words (``_vec``)."""
    ts = [x for x in (a, b) if isinstance(x, torch.Tensor)]
    shape = broadcast_shape(*(t.shape for t in ts))
    sizes, strides = plan(shape, ts)
    tensor_strides = iter(strides[1:])
    operands = [(x, next(tensor_strides), 0) if isinstance(x, torch.Tensor)
                else (None, None, x % gl.P if op == "mul" else x & MASK64) for x in (a, b)]
    return shape, sizes, operands, _vec(sizes, [(t, st) for t, st, _ in operands if t is not None])


def reduce_plan(tensors, dim: int):
    """(out_shape, K, sizes, strides, vec) of a reduction of the tensors'
    broadcast shape over axis `dim` (K terms): the output's shape, collapsed
    to DIMS axes with the output's strides first, then each tensor's, each
    tensor's followed by its stride along `dim`; and whether a thread takes
    two words (``_vec``)."""
    shape = broadcast_shape(*(t.shape for t in tensors))
    if not -len(shape) <= dim < len(shape):
        raise ValueError(f"field reduction: no axis {dim} in a shape {tuple(shape)}")
    dim %= len(shape)
    out_shape = shape[:dim] + shape[dim + 1:]
    full = [broadcast_strides(t, shape) for t in tensors]
    along = [s.pop(dim) for s in full]
    sizes, strides = collapse(out_shape, [contiguous_strides(out_shape)] + full)
    strides = strides[:1] + [s + [k] for s, k in zip(strides[1:], along)]
    return out_shape, shape[dim], sizes, strides, _vec(sizes, list(zip(tensors, strides[1:])))


def _check(what: str, xs, ints: bool):
    """The tensors among xs, checked: int64, on one CPU or CUDA device; the
    rest Python ints where `ints` allows them, and one tensor at least."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    kinds = (torch.Tensor, int) if ints else torch.Tensor
    if not ts or any(not isinstance(x, kinds) for x in xs):
        raise TypeError(f"{what}: takes int64 tensors{' and Python ints' if ints else ''}, "
                        f"a tensor at least; got {[type(x).__name__ for x in xs]}")
    _build.check_tensors(what, *ts, contiguous=False)
    return ts


def _vec(sizes, operands) -> int:
    """1 where a thread can take two words of the innermost axis: its size
    even, and each tensor of (tensor, strides) read there by 8-byte loads of
    one word (stride 0) or 16-byte loads of two (stride 1, every other
    stride even, the pointer 16-byte aligned)."""
    if sizes[-1] % 2:
        return 0
    for t, strides in operands:
        if strides[DIMS - 1] == 0:
            continue
        others = strides[:DIMS - 1] + strides[DIMS:]
        if strides[DIMS - 1] != 1 or any(s % 2 for s in others) or t.data_ptr() % 16:
            return 0
    return 1


def _launch(fn, entry: str, out, *args):
    with torch.cuda.device(out.device):
        _build.check(getattr(_build.library(), entry)(*args, _build.stream_ptr(out)), entry)
    fn.launches += 1
    return out


def _binary(fn, a, b, plain):
    ts = _check(f"field {fn.__name__}", (a, b), ints=True)
    shape, sizes, operands, vec = binary_plan(fn.__name__, a, b)
    if ts[0].device.type == "cpu":
        return plain()
    out = torch.empty(shape, dtype=torch.int64, device=ts[0].device)
    if out.numel() == 0:
        return out
    args = []
    for t, strides, value in operands:
        args += [t.data_ptr(), _Strides(*strides), 0] if t is not None else [None, None, value]
    return _launch(fn, "gl_binary", out, _OPS[fn.__name__], *args, out.data_ptr(),
                   _Strides(*sizes), vec)


def add(a, b):
    """a + b mod p."""
    return _binary(add, a, b, lambda: gl.add(a, b))


def sub(a, b):
    """a - b mod p."""
    return _binary(sub, a, b, lambda: gl.sub(a, b))


def mul(a, b):
    """a * b mod p."""
    return _binary(mul, a, b, lambda: gl.mul(a, b))


def neg(a):
    """-a mod p."""
    return _binary(neg, a, 0, lambda: gl.neg(a))


def _reduce(fn, tensors, dim: int, plain):
    ts = _check(f"field {fn.__name__}", tensors, ints=False)
    out_shape, K, sizes, strides, vec = reduce_plan(ts, dim)
    if K >= MAX_WORDS:
        raise ValueError(f"field {fn.__name__}: {K} terms; the kernel takes fewer than 2^31")
    if ts[0].device.type == "cpu":
        return plain()
    out = torch.empty(out_shape, dtype=torch.int64, device=ts[0].device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    args = [ts[0].data_ptr(), _Strides(*strides[1])]
    args += [ts[1].data_ptr(), _Strides(*strides[2])] if len(ts) == 2 else [None, None]
    return _launch(fn, "gl_reduce", out, *args, K, out.data_ptr(), _Strides(*sizes), vec)


def sum_mod(x, dim: int):
    """The sum over axis `dim` mod p."""
    return _reduce(sum_mod, (x,), dim, lambda: gl.sum_mod(x, dim))


def dot_mod(x, w, dim: int):
    """The sum over axis `dim` of x * w mod p (x and w broadcast together)."""
    return _reduce(dot_mod, (x, w), dim, lambda: gl.sum_mod(gl.mul(x, w), dim))


for _fn in (add, sub, mul, neg, sum_mod, dot_mod):
    _fn.launches = 0
    _fn.replayed = 0
del _fn
