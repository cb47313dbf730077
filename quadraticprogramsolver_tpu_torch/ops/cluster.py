"""The thread-block cluster that holds one lane in the cluster chunks
(csrc/cluster.cuh, used by the sigma-free csrc/admm_chunk_cluster.cu and
csrc/prox_chunk_cluster.cu and the M^{-1}-form
csrc/admm_chunk_minv_cluster.cu and csrc/prox_chunk_minv_cluster.cu): its
size, one CTA's shared memory, and the lane shapes whose matrices fit it.
Each family's ``chunk_kernel`` and ``minv_chunk_kernel`` asks :func:`fits`
with its own shared-memory formula."""

from __future__ import annotations

from typing import Callable

#: CTAs of the cluster that holds one lane (8, the portable cluster size).
CLUSTER = 8
#: Shared memory one CTA can have on the H100 (227 KB).
SMEM_PER_CTA = 232448


def fits(n: int, m: int, smem_bytes: Callable[[], int],
         smem_per_cta: int = SMEM_PER_CTA) -> bool:
    """Whether a lane whose two matrices are n x m and m x n fits the
    cluster: n and m multiples of 128 up to 512 whose rows fit the cluster's
    registers ((n/128)(m/128) <= 8: a thread of a sigma-free chunk holds 8
    (n/128)(m/128) matrix floats, one of an M^{-1}-form chunk its n x n
    inverse's and A's 4 (n/128)(n/128 + m/128), at most 96 there), and
    ``smem_bytes()``, one CTA's shared memory at that shape (asked only when
    the registers fit), within ``smem_per_cta``."""
    nb, mb = n // 128, m // 128
    return (n % 128 == 0 and m % 128 == 0 and 0 < nb <= 4 and 0 < mb <= 4
            and nb * mb <= 8 and smem_bytes() <= smem_per_cta)
