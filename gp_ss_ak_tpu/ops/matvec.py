"""Matrix-free Gram products: A V with A = s^2 exp(-dist) + bias + sn2 I,
K never held in memory.

At N = 100k the kernel matrix is 40 GB in float32, so the large-N CG
and Lanczos loops (inference/iterative.py) apply it tile by tile. Only
the exponential part E_ij = exp(-||xi - xj||) is streamed; s^2, the
rank-1 bias and the noise diagonal are applied outside in three XLA
ops: A V = s^2 (E V) + bias 1 (1' V) + sn2 V.

Two routes compute E V, chosen by `stream_route(B)` from the backend
and the width of V:

  triton  (GPU, at most BB columns) a Pallas kernel compiled through
          Triton. One program owns a (TM, BB) output block and loops
          over all column tiles inside the kernel, so the E tile lives in registers from the
          distance FMAs through sqrt/exp to the float32 product with
          the V tile; nothing N^2-sized touches device memory.
  xla     (wider V on a GPU, every V elsewhere) row blocks of E built
          by the plain tile (ops/gram.py) and multiplied by V; each E
          block is written to memory and read back by the product.

The split by width is measured (PERF.md): the kernel's full-precision
float32 product runs on the FMA units, so its time grows with the
width of V, while the XLA route pays a fixed cost for writing E and
hands the product to cuBLAS. The kernel wins for the CG solves (y plus
a few probes) and loses for the 32- and 64-column blocks. For a single
vector XLA turns the product into a reduction fused with the E build,
which runs ~15% faster than the kernel but took minutes to compile on
the card, so one vector stays on the kernel.

Both compute squared distances as broadcast differences, so the
diagonal entry is exactly exp(-0) = 1 and padding needs no masking:
padded points carry zero rows of V.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gp_ss_ak_tpu.ops.gram import expans_bias_gram, sqdist

#: Triton tile: rows per program and columns per inner-loop step
TM = 64
TN = 64
#: V columns per program: the `pl.dot` minimum, and the widest V the
#: kernel beats the XLA route on (see the module docstring)
BB = 16
NUM_WARPS = 4
NUM_STAGES = 2

#: rows of E per block on the XLA route (a (chunk, N) float32 block is
#: 0.8 GB at N = 100k)
XLA_ROW_CHUNK = 2048

_HIGHEST = jax.lax.Precision.HIGHEST


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_route(b: int) -> str:
    """The E V route for a V of `b` columns: the compiled Triton
    kernel on a GPU for b <= BB, the plain-XLA build otherwise."""
    return ("triton" if jax.default_backend() == "gpu" and b <= BB
            else "xla")


def _matmat_kernel(xr_ref, xc_ref, v_ref, out_ref, *, d: int,
                   n_col_tiles: int):
    """out (TM, BB) = sum_j E(rows, cols_j) @ V(cols_j, :)."""
    xi = [xr_ref[k, :] for k in range(d)]          # d x (TM,)

    def body(j, acc):
        cols = pl.ds(j * TN, TN)
        d2 = jnp.zeros((TM, TN), jnp.float32)
        for k in range(d):                          # d unrolled FMAs
            diff = xi[k][:, None] - xc_ref[k, cols][None, :]
            d2 = d2 + diff * diff
        e = jnp.exp(-jnp.sqrt(d2))
        return acc + pl.dot(e, v_ref[cols, :], precision=_HIGHEST)

    acc0 = jnp.zeros(out_ref.shape, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, n_col_tiles, body, acc0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def triton_matmat(Xm, V, interpret: bool = False):
    """E @ V, E_ij = exp(-||xm_i - xm_j||), through the Triton kernel.
    Xm (n, d) float32 mapped points, V (n, B). `interpret=True` runs
    the same kernel in the Pallas interpreter (tests only)."""
    Xm = jnp.asarray(Xm, jnp.float32)
    V = jnp.asarray(V, jnp.float32)
    n, d = Xm.shape
    b = V.shape[1]
    npad = _round_up(n, max(TM, TN))
    bpad = _round_up(b, BB)
    Xt = jnp.zeros((d, npad), jnp.float32).at[:, :n].set(Xm.T)
    Vp = jnp.zeros((npad, bpad), jnp.float32).at[:n, :b].set(V)
    kern = functools.partial(_matmat_kernel, d=d, n_col_tiles=npad // TN)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((npad, bpad), jnp.float32),
        grid=(npad // TM, bpad // BB),
        in_specs=[
            pl.BlockSpec((d, TM), lambda i, c: (0, i)),     # row points
            pl.BlockSpec((d, npad), lambda i, c: (0, 0)),   # all points
            pl.BlockSpec((npad, BB), lambda i, c: (0, c)),  # V columns
        ],
        out_specs=pl.BlockSpec((TM, BB), lambda i, c: (i, c)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="stream_gram_matmat",
    )(Xt, Xt, Vp)
    return out[:n, :b]


@jax.jit
def xla_matmat(Xm, V):
    """E @ V by row blocks of E built with the plain tile."""
    Xm = jnp.asarray(Xm, jnp.float32)
    V = jnp.asarray(V, jnp.float32)
    n = Xm.shape[0]
    chunk = min(XLA_ROW_CHUNK, _round_up(n, 8))
    npad = _round_up(n, chunk)
    Xp = jnp.zeros((npad, Xm.shape[1]), jnp.float32).at[:n].set(Xm)

    def one(c):
        rows = jax.lax.dynamic_slice_in_dim(Xp, c * chunk, chunk)
        E = jnp.exp(-jnp.sqrt(sqdist(rows, Xm)))    # (chunk, n)
        return jnp.matmul(E, V, precision=_HIGHEST)

    out = jax.lax.map(one, jnp.arange(npad // chunk))
    return out.reshape(npad, -1)[:n]


def streamed_matmat(Xm, s2, bias, sn2, V):
    """A @ V, V (n, B): every column rides one pass over the tiles."""
    V = jnp.asarray(V, jnp.float32)
    EV = (triton_matmat(Xm, V) if stream_route(V.shape[1]) == "triton"
          else xla_matmat(Xm, V))
    return s2 * EV + bias * jnp.sum(V, axis=0)[None, :] + sn2 * V


class MaterializedOperator:
    """A = s^2 exp(-dist) + bias + sn2 I, with K built ONCE by the plain
    Gram (ops/gram.py) and held in device memory; every matvec/matmat
    is then one GEMM instead of an O(N^2) kernel rebuild.

    store_dtype=bfloat16 halves the footprint; the matvec result is
    then accurate to ~1e-3 relative (f32 accumulation over bf16
    entries), which bounds the achievable CG residual. CAUTION: the
    quantization noise has spectral norm ~ 0.002 sqrt(N) — larger than
    the flagship sn2 = 0.016 beyond N ~ 10^3 — so A_bf16 can be
    indefinite and logdet estimates over it are biased
    (inference.iterative.choose_mode never auto-picks it). f32 storage
    uses HIGHEST-precision GEMMs.

    The noise diagonal is NEVER quantized: only K = s^2 exp(-dist) +
    bias is stored (in store_dtype); sn2 * v is added in f32 inside
    matmat, so rounding cannot push a near-singular A off SPD.
    """

    def __init__(self, Xm, sigma, bias, sn2, store_dtype=jnp.float32):
        Xm = jnp.asarray(Xm, jnp.float32)
        self.A = expans_bias_gram(Xm, sigma, bias).astype(store_dtype)
        self.sn2 = jnp.asarray(sn2, jnp.float32)
        self._prec = (_HIGHEST if store_dtype == jnp.float32
                      else jax.lax.Precision.DEFAULT)

    def __call__(self, v):
        return self.matmat(jnp.asarray(v)[:, None])[:, 0]

    def matmat(self, V):
        V = jnp.asarray(V, jnp.float32)
        KV = jnp.matmul(self.A, V.astype(self.A.dtype),
                        precision=self._prec,
                        preferred_element_type=jnp.float32)
        return KV + self.sn2 * V


class MatvecOperator:
    """A = s^2 exp(-dist) + bias + sn2 I as a streamed matvec closure.

    Xm: metric-mapped recentred points (n, d) — see
    ops/gram.mapped_points."""

    def __init__(self, Xm, sigma, bias, sn2):
        self.Xm = jnp.asarray(Xm, jnp.float32)
        sigma = jnp.asarray(sigma, jnp.float32)
        self.s2 = sigma * sigma
        self.bias = jnp.asarray(bias, jnp.float32)
        self.sn2 = jnp.asarray(sn2, jnp.float32)

    def __call__(self, v):
        return self.matmat(jnp.asarray(v)[:, None])[:, 0]

    def matmat(self, V):
        return streamed_matmat(self.Xm, self.s2, self.bias, self.sn2, V)
