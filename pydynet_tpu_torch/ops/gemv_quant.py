"""Weight-quantized matmuls of the big-dims decode lane: the ports of the
Pallas TPU kernels of ``pydynet_tpu/ops/gemv_quant.py`` (K5 ``_kgrid_kernel``
:172, K6 ``_qmm_kernel`` :136, K7 the inner ``kernel`` of
``qmatmul_stacked`` :416).

``qmatmul(x, wq, ws, q4)`` multiplies (M, K) float32, bfloat16 or float16
rows by weights quantized with ``ops.quant.quantize_int8(w, axis=0)`` ((K,
N) int8) or ``quantize_int4(w, axis=0)`` ((K/2, N) packed, ``q4=True``),
with per-output-channel float32 scales ``ws`` (1, N), and returns (M, N)
float32 (for float16 rows too, as the JAX package's ``qmatmul`` returns).
``qmatmul_stacked(x, wq_all, ws_all, idx, q4)`` does the same against layer
``idx`` of layer-stacked (L, Kst, N) / (L, 1, N) weights, ``idx`` a Python
int or a 0-d int32 tensor on the weights' device. The layouts are the JAX
package's. The arithmetic is its ``qmatmul_ref``'s, bit for bit: each row is
quantized to int8 with its own scale (``quantize_rows``: absmax floored at
1e-30, ``round(x * (127 / amax))``, ``sx = amax / 127``), the product is an
exact int32 sum, and ``out = (float(acc) * ws) * sx``.

For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/gemv_quant.cu``: for M <= ``MAX_DECODE_ROWS`` rows one launch of the
decode kernel (K5; K7 with a layer index), which quantizes the rows itself
and needs no scratch (above ``FUSED_QUANT_MAX_ROWS`` rows the rows are
quantized by ``quantize_rows`` first); for more rows the activation
quantization, then the prefill kernel (K6; K7 with an index). For CPU
tensors they run the plain versions (``quantize_rows_ref``,
``qmatmul_ref``). They never move data between devices and never fall
back: a CUDA input a kernel does not take raises. Each wrapper counts its
kernel launches: ``quantize_rows.launches`` (the standalone quantization),
``qmatmul.launches`` (K5), ``qmatmul.prefill_launches`` (K6) and
``qmatmul_stacked.launches`` (K7, either kernel), of which
``qmatmul_stacked.prefill_launches`` counts those on the prefill kernel
(K6's, with a layer index). ``decode_plan`` is the
decode kernel's launch plan: its K split (a thread-block cluster), its
staging of the int8 rows and its shared memory.

Not ported: ``_VMEM_BUDGET``, ``_auto_nt``, ``_pick_kt``, ``pick_nt`` and
``_M_SLAB``. They size tiles and row slabs to the TPU's VMEM; the CUDA
kernels choose their own tiles from the shapes, take every M, every K (even
for int4) and every N that is a multiple of 4, and never fall back to
another layout.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .quant import unpack_int4

MAX_DECODE_ROWS = 32  # kMaxDecodeRows in csrc/gemv_quant.cu (K5's M bound)
# The decode kernel quantizes its rows itself up to this many rows, one
# launch a product; above it a quantize_rows launch comes first, which on
# the H100 costs less device time from 6 rows on (PERF.md)
FUSED_QUANT_MAX_ROWS = 4
# the row types' codes (kXF32, kXBF16, kXF16 in csrc/gemv_quant.cuh)
_XDTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_X_INT8 = 2  # kXInt8: rows quantized beforehand
# the routes of a product on the card: the decode kernel quantizing its
# rows itself, the decode kernel on rows that quantize_rows made, and the
# prefill kernel on them (``_route`` picks one by M)
_FUSED, _INT8_ROWS, _PREFILL = "fused", "quantize_rows first", "prefill"
_ROUTES = (_FUSED, _INT8_ROWS, _PREFILL)
_INT8_MAX = torch.tensor(127.0)

# the decode kernel's geometry (csrc/gemv_quant.cu) and the card's limits
DECODE_COLS = 128  # kDCols: columns of a block
DECODE_STAGE_ROWS = 64  # kDStageRows: packed weight rows a ring stage
DECODE_STAGES = 3  # the weight ring's depth (kDMaxStages at most): deeper
# rings were slower at every 7B shape on the H100
MAX_CLUSTER = 8  # kMaxCluster: a portable thread-block cluster
SMEM_MAX = 232448  # kSmemMax: 227 KB of shared memory a block
SMS = 132  # an H100 SXM's streaming multiprocessors
# K split: about two blocks an SM (more blocks, or a split chosen to even
# out the blocks an SM holds, were slower at the 7B shapes on the H100)
DECODE_TARGET_BLOCKS = 2 * SMS
DECODE_X_BYTES = 64 * 1024  # shared memory for a chunk of the int8 rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def decode_plan(q4: bool, M: int, K: int, N: int):
    """The decode kernel's launch plan for M <= MAX_DECODE_ROWS rows of K
    against (K, N) weights (q4: (K/2, N) packed): ``(cluster, slice, chunk,
    mt, wm, stages, smem)``. ``cluster`` blocks (a thread-block cluster, at
    most MAX_CLUSTER) split the packed rows of each 128-column tile,
    ``slice`` rows each (a multiple of a stage), enough to put about
    DECODE_TARGET_BLOCKS blocks on the card and no block without rows; the
    int8 rows wait in shared memory ``chunk`` packed rows at a time; warps
    take ``wm`` row tiles of ``mt`` rows; the weight ring has ``stages``
    stages (DECODE_STAGES, 2 for a slice of one stage); ``smem`` bytes of
    dynamic shared memory (``decode_smem`` in csrc/gemv_quant.cu)."""
    kst = K // 2 if q4 else K
    tiles = _cdiv(N, DECODE_COLS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(DECODE_TARGET_BLOCKS, tiles),
                         _cdiv(kst, DECODE_STAGE_ROWS)))
    rows = DECODE_STAGE_ROWS * _cdiv(_cdiv(kst, cluster), DECODE_STAGE_ROWS)
    cluster = _cdiv(kst, rows)
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    wm = 1 if M <= 8 else 2 if M <= 16 else 4
    halves = 2 if q4 else 1
    fit = DECODE_X_BYTES // (halves * mt * wm)
    chunk = min(rows, max(DECODE_STAGE_ROWS,
                          fit // DECODE_STAGE_ROWS * DECODE_STAGE_ROWS))
    share = 4 * _cdiv(DECODE_COLS // 4, cluster)  # decode_share
    rest = mt * wm * (DECODE_COLS * 4 + halves * chunk + cluster * share * 4)
    stages = max(2, min(DECODE_STAGES, _cdiv(rows, DECODE_STAGE_ROWS)))
    return (cluster, rows, chunk, mt, wm, stages,
            stages * DECODE_STAGE_ROWS * DECODE_COLS + rest)


def quantize_rows_ref(x: torch.Tensor):
    """Per-row symmetric int8 of (M, K) activations: ``(xq, sx)``, int8
    (M, K) and float32 (M, 1) (``gemv_quant.py:309-315``)."""
    x32 = x.float()
    amax = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-30)
    q = torch.round(x32 * _INT8_MAX.to(x32.device).div(amax))  # IEEE 127/a
    return q.to(torch.int8), amax * (1.0 / 127.0)


def _product_ref(xq, wq, q4):
    """The exact int32 (M, N) sum of xq (M, K) int8 with wq: through float64,
    exact because every partial sum is an integer below K * 127^2 < 2^53
    (and PyTorch has no int32 matmul on CUDA)."""
    xd = xq.double()
    if q4:
        lo, hi = unpack_int4(wq)
        k2 = wq.shape[0]
        acc = xd[:, :k2] @ lo.double() + xd[:, k2:] @ hi.double()
    else:
        acc = xd @ wq.double()
    return acc.to(torch.int32)


def qmatmul_ref(x, wq, ws, q4: bool = False):
    """The plain-PyTorch version of :func:`qmatmul` (the JAX package's
    ``qmatmul_ref`` in torch): same arguments and bits, on any device."""
    xq, sx = quantize_rows_ref(x)
    return (_product_ref(xq, wq, q4).float() * ws.float()) * sx


def qmatmul_stacked_ref(x, wq_all, ws_all, idx, q4: bool = False):
    """The plain version of :func:`qmatmul_stacked`."""
    i = int(idx)
    return qmatmul_ref(x, wq_all[i], ws_all[i], q4)


def _check(x, wq, ws, q4, stacked):
    """Raise unless the arguments have the module doc's layouts. Returns
    (M, K, N, L)."""
    if x.dim() != 2 or x.dtype not in _XDTYPES:
        raise ValueError(f"x: expected (M, K) float32, bfloat16 or float16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    if wq.dtype != torch.int8 or wq.dim() != (3 if stacked else 2):
        raise ValueError(f"wq: expected int8 with {3 if stacked else 2} "
                         f"dims, got {wq.dtype} {tuple(wq.shape)}")
    L, Kst, N = wq.shape if stacked else (1,) + tuple(wq.shape)
    if (2 * Kst if q4 else Kst) != K:
        raise ValueError(f"x {tuple(x.shape)} does not match wq "
                         f"{tuple(wq.shape)} (q4={q4})")
    want = (L, 1, N) if stacked else (1, N)
    if ws.dtype != torch.float32 or tuple(ws.shape) != want:
        raise ValueError(f"ws: expected float32 {want}, got {ws.dtype} "
                         f"{tuple(ws.shape)}")
    if M < 1:
        raise ValueError("x has no rows")
    for name, t in (("wq", wq), ("ws", ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return M, K, N, L


def _check_cuda(x, wq, ws, N):
    if x.device.type != "cuda":
        raise ValueError(f"no quantized matmul kernel for device {x.device}")
    if N % 4:
        raise ValueError(f"beyond the kernel's limits: N={N} is not a "
                         "multiple of 4")
    for name, t in (("x", x), ("wq", wq), ("ws", ws)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wq.data_ptr() % 4:
        raise ValueError("wq must be 4-byte aligned")


def quantize_rows(x: torch.Tensor):
    """Per-row int8 of (M, K) activations, ``(xq, sx)`` as
    :func:`quantize_rows_ref` gives them. CUDA tensors launch
    ``quantize_rows_kernel``."""
    if x.dim() != 2 or x.dtype not in _XDTYPES or x.shape[0] < 1:
        raise ValueError(f"x: expected (M, K) float32, bfloat16 or float16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no quantization kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    M, K = x.shape
    lib = _build.load()
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        quantize_rows.launches += 1
        err = lib.pdt_quantize_rows(_XDTYPES[x.dtype], x.data_ptr(),
                                    xq.data_ptr(), sx.data_ptr(), M, K,
                                    stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows launch failed: CUDA error {err}")
    return xq, sx


quantize_rows.launches = 0


def _route(M: int) -> str:
    """The route of a product of M rows: one launch of the decode kernel
    up to FUSED_QUANT_MAX_ROWS rows, ``quantize_rows`` and the decode
    kernel up to MAX_DECODE_ROWS, ``quantize_rows`` and the prefill kernel
    above."""
    if M <= FUSED_QUANT_MAX_ROWS:
        return _FUSED
    return _INT8_ROWS if M <= MAX_DECODE_ROWS else _PREFILL


def _product(x, wq, ws, q4, idx, L, route):
    """Launch the product of x's rows with layer ``idx`` of wq by ``route``
    (one of ``_ROUTES``; the decode kernel's routes take M <=
    MAX_DECODE_ROWS); returns the (M, N) float32 result. The wrappers pass
    ``_route(M)``; a check of every route calls this directly."""
    M, K = x.shape
    N = wq.shape[-1]
    if route not in _ROUTES or (route != _PREFILL and M > MAX_DECODE_ROWS):
        raise ValueError(f"no route {route!r} for {M} rows")
    decode = route != _PREFILL
    xq, sx = (None, None) if route == _FUSED else quantize_rows(x)
    lib = _build.load()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    dev_idx = isinstance(idx, torch.Tensor)
    ip, ih = (idx.data_ptr(), 0) if dev_idx else (None, idx)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if not decode:
            err = lib.pdt_qmm(int(q4), xq.data_ptr(), sx.data_ptr(),
                              wq.data_ptr(), ws.data_ptr(), ip, ih, L,
                              out.data_ptr(), M, K, N, stream)
        else:
            cluster, rows, chunk, mt, wm, stages, _ = decode_plan(q4, M, K,
                                                                  N)
            xt, rows_in, scales = ((_XDTYPES[x.dtype], x, None) if xq is None
                                   else (_X_INT8, xq, sx.data_ptr()))
            err = lib.pdt_qmm_decode(int(q4), xt, rows_in.data_ptr(), scales,
                                     wq.data_ptr(), ws.data_ptr(), ip, ih, L,
                                     out.data_ptr(), M, K, N, cluster, rows,
                                     chunk, mt, wm, stages, stream)
    if err != 0:
        raise RuntimeError(f"quantized matmul launch failed: CUDA error "
                           f"{err}")
    return out


def qmatmul(x, wq, ws, q4: bool = False):
    """(M, K) x quantized (K, N) -> (M, N) float32 (see the module doc).
    CUDA tensors launch the decode kernel (K5) at M <= ``MAX_DECODE_ROWS``,
    the prefill kernel (K6) above."""
    M, K, N, _ = _check(x, wq, ws, q4, stacked=False)
    if x.device.type == "cpu":
        return qmatmul_ref(x, wq, ws, q4)
    _check_cuda(x, wq, ws, N)
    out = _product(x, wq, ws, q4, 0, 1, _route(M))
    if M <= MAX_DECODE_ROWS:
        qmatmul.launches += 1
    else:
        qmatmul.prefill_launches += 1
    return out


qmatmul.launches = 0
qmatmul.prefill_launches = 0


def qmatmul_stacked(x, wq_all, ws_all, idx, q4: bool = False):
    """:func:`qmatmul` against layer ``idx`` of stacked (L, Kst, N) weights
    with (L, 1, N) scales, bit-identical to ``qmatmul(x, wq_all[idx],
    ws_all[idx])``. On a GPU ``idx`` may be a 0-d int32 tensor on the
    device: the kernel reads it there and offsets the weight pointers
    itself, so nothing is sliced or copied (an index outside [0, L) is
    clamped, as ``jax.lax.dynamic_index_in_dim`` clamps it)."""
    M, K, N, L = _check(x, wq_all, ws_all, q4, stacked=True)
    if isinstance(idx, torch.Tensor):
        if idx.dim() != 0 or idx.dtype != torch.int32 \
                or idx.device != x.device:
            raise ValueError(f"idx: expected a 0-d int32 tensor on "
                             f"{x.device}, got {idx.dtype} "
                             f"{tuple(idx.shape)} on {idx.device}")
    elif not 0 <= idx < L:
        raise ValueError(f"layer {idx} outside [0, {L})")
    if x.device.type == "cpu":
        return qmatmul_stacked_ref(x, wq_all, ws_all, idx, q4)
    _check_cuda(x, wq_all, ws_all, N)
    out = _product(x, wq_all, ws_all, q4, idx, L, _route(M))
    qmatmul_stacked.launches += 1
    if M > MAX_DECODE_ROWS:
        qmatmul_stacked.prefill_launches += 1
    return out


qmatmul_stacked.launches = 0
qmatmul_stacked.prefill_launches = 0
