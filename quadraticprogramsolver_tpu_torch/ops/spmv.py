"""ELL sparse matrix-vector product (csrc/ell_matvec.cu).

The JAX package's sparse matvec is ``core/sparse_problem.py:_ell_matvec``,
``sum(vals * v[cols], axis=-1)`` over row-major (rows, k) ELL arrays whose
padding slots hold value 0 and column 0; its Pallas form is the probe kernel
``benchmarks/ell_kernel_probe.py:84``. :func:`ell_matvec` is that product:
on a CUDA tensor it launches the hand-written kernel, on a CPU tensor it runs
:func:`ell_matvec_plain`. :func:`ell_matvec_prev` launches the kernel it
replaced, kept as its witness.
"""

from __future__ import annotations

import torch

from .. import _build


def ell_matvec_plain(vals: torch.Tensor, cols: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """(rows, k) ELL x (n,) -> (rows,): the gather and the row sums."""
    return (vals * v[cols]).sum(-1)


def _launch(wrapper, entry, vals, cols, v):
    """Check the operands and launch ``entry`` on them, counted on
    ``wrapper``; returns y."""
    name = wrapper.__name__
    if vals.ndim != 2 or tuple(cols.shape) != tuple(vals.shape) or v.ndim != 1:
        raise ValueError(f"{name}: vals and cols must be one (rows, k) "
                         f"shape and v a vector; got {tuple(vals.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(v.shape)}")
    _build.require_cuda(name, (vals, torch.float32), (cols, torch.int32),
                        (v, torch.float32))
    rows, k = vals.shape
    y = torch.empty(rows, dtype=torch.float32, device=vals.device)
    _build.launch(wrapper, entry, vals.data_ptr(), cols.data_ptr(),
                  v.data_ptr(), y.data_ptr(), rows, k,
                  _build.stream_ptr(vals))
    return y


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_j vals[r, j] * v[cols[r, j]].

    On a CUDA tensor this launches csrc/ell_matvec.cu and counts it in
    ``ell_matvec.launches``: ``vals`` float32 and ``cols`` int32, both
    contiguous (rows, k), ``v`` a contiguous float32 vector on the same card
    with every column index below its length (not checked: that would read
    the indices back); anything else raises. On a CPU tensor it runs
    :func:`ell_matvec_plain`.
    """
    if not _build.launches_kernel("ell_matvec", vals):
        return ell_matvec_plain(vals, cols, v)
    return _launch(ell_matvec, "qps_ell_matvec", vals, cols, v)


ell_matvec.launches = 0


def ell_matvec_prev(vals: torch.Tensor, cols: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """:func:`ell_matvec` through the kernel it replaced (one sub-warp of
    up to 32 lanes a row, one slot a lane per pass): its witness and timing
    baseline on the card (no solver calls it). Counts on its own
    ``launches``; on a CPU tensor the plain version."""
    if not _build.launches_kernel("ell_matvec_prev", vals):
        return ell_matvec_plain(vals, cols, v)
    return _launch(ell_matvec_prev, "qps_ell_matvec_prev", vals, cols, v)


ell_matvec_prev.launches = 0
