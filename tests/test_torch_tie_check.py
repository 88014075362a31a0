"""The `gpu` lane's tie-robust check (``chip_smoke.against_plain``) on the
CPU, built from the plain versions.

The lane holds each batch row of a kernel's step to the plain version run
on the card; a row that fails is held to the plain version run on the
CPU, and its logits with the int8 KV cache to the plain step
teacher-forced on the cache rows the kernel wrote, where those differ
from the plain step's own only at rounding ties, with the same
tolerances. Here the references are made the way float noise makes them:
one activation lies exactly on a rounding tie of its int8 quantization,
and the second reference sees it one float32 ulp higher, as another
summation order may give it, so the two round it to neighbouring
integers; and a kernel's int8 KV row rounds an entry that lies on a tie
the other way. The check must accept a kernel row that took the other
side of such a tie, and must reject a kernel row with a flipped entry
that no reference rounds that way: an activation, the absmax of a KV row
or a KV entry far from a tie.
"""
import types

import numpy as np
import pytest
import torch

from chip_smoke import KV8_TIE_STEPS, QUANT_CACHE_ATOL, against_plain
from pydynet_tpu_torch.ops import decode_step as dsk
from pydynet_tpu_torch.ops import gemv_quant as gq

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

M, K, N = 4, 64, 32
TIE = (1, 5)  # x * 127 / amax = 2.5: round half to even gives 2
OTHER = (2, 7)  # x * 127 / amax = 1.2, far from a tie


def inputs():
    """Rows whose amax is 127 (so x * 127 / amax is x itself), int8
    weights whose rows TIE[1] and OTHER[1] move every output by a whole
    step well beyond QUANT_CACHE_ATOL, and per-channel scales."""
    rng = np.random.default_rng(0)
    x = np.round(rng.uniform(-100, 100, (M, K))).astype(np.float32)
    x[:, 0] = 127.0
    x[TIE] = 2.5
    x[OTHER] = 1.2
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    w[TIE[1]] = w[OTHER[1]] = 100
    ws = np.full((1, N), 0.01, np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ws)


def references():
    """The plain product on the inputs (the card's reference) and on the
    inputs with the tie one float32 ulp higher (the CPU's)."""
    x, w, ws = inputs()
    nudged = x.clone()
    nudged[TIE] = float(np.nextafter(np.float32(2.5), np.float32(3)))
    xq_a = gq.quantize_rows_ref(x)[0]
    xq_b = gq.quantize_rows_ref(nudged)[0]
    assert int(xq_a[TIE]) == 2 and int(xq_b[TIE]) == 3
    assert torch.equal(xq_a[torch.arange(M) != TIE[0]],
                       xq_b[torch.arange(M) != TIE[0]])
    return gq.qmatmul_ref(x, w, ws), gq.qmatmul_ref(nudged, w, ws)


def rows_err(got, ref):
    return (got - ref).abs().amax(dim=-1).tolist()


def check(got, a, b):
    calls = []

    def cpu_errs():
        calls.append(1)
        return rows_err(got, b)

    errs, took = against_plain(rows_err(got, a), [cpu_errs],
                               lambda e: e <= QUANT_CACHE_ATOL)
    return max(errs) <= QUANT_CACHE_ATOL, took, len(calls)


def test_tie_check_accepts_the_plain_bits_without_the_cpu():
    a, b = references()
    assert check(a.clone(), a, b) == (True, [0] * M, 0)


def test_tie_check_accepts_a_flipped_tie():
    """The kernel's row 1 rounds the tie the other way: the card's
    reference alone rejects it (a whole step, beyond QUANT_CACHE_ATOL), the
    check takes the CPU's reference for that row only."""
    a, b = references()
    got = a.clone()
    got[TIE[0]] = b[TIE[0]]
    assert max(rows_err(got, a)) > QUANT_CACHE_ATOL
    assert check(got, a, b) == (True, [int(i == TIE[0]) for i in range(M)],
                                1)


def test_tie_check_rejects_a_flipped_non_tie_entry():
    """Row 2 with its 1.2 rounded to 2 instead of 1: neither reference
    rounds it so, and the check fails."""
    a, b = references()
    x, w, ws = inputs()
    xq, sx = gq.quantize_rows_ref(x)
    xq[OTHER] += 1
    got = (gq._product_ref(xq, w, False).float() * ws) * sx
    assert rows_err(got, a)[OTHER[0]] > QUANT_CACHE_ATOL
    ok, took, calls = check(got, a, b)
    assert not ok and not any(took) and calls == 1


def tiny_step(kv8, seed=0, batch=3):
    """A tiny float32 model's plain batched step at pos 0 (every row attends
    to its new cache row alone): (the step's arguments, their caches after
    the step, the logits)."""
    from chip_smoke import batched_args, random_caches
    from pydynet_tpu_torch.models.llama import Llama

    model = Llama(vocab_size=256, embed_dim=64, n_heads=4, ffn_dim=128,
                  max_seq_len=16, n_layers=2, device="cpu",
                  generator=torch.Generator().manual_seed(seed)).eval()
    w = model._fused_weights(torch.float32, None)
    ck, cv = random_caches(model, torch.float32, seed, batch, kv8)
    args, kw = batched_args(model, w, ck, cv, 0, [5, 77, 200][:batch])
    logits = dsk.decode_token_batched_logits_ref(*args, **kw)
    return args, kw, (ck, cv), logits


def forced_rows(ck, cv):
    return (ck[0], cv[0], ck[1], cv[1]) if isinstance(ck, tuple) \
        else (ck, cv, None, None)


def fresh(args, kw, kv8, seed=0, batch=3):
    """The step's arguments again, on the caches as they were before it."""
    from chip_smoke import random_caches

    ck, cv = random_caches(types.SimpleNamespace(
        device=torch.device("cpu"), n_layers=2, max_seq_len=16,
        embed_dim=64), torch.float32, seed, batch, kv8)
    kw = dict(kw)
    if kv8:
        (ck, kw["sk"]), (cv, kw["sv"]) = ck, cv
    return args[:-2] + (ck, cv), kw


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_teacher_forcing_on_its_own_rows_is_the_plain_step(kv8):
    """The plain step teacher-forced on the rows it wrote itself gives its
    own logits, bit for bit: the hook only swaps the rows."""
    args, kw, (ck, cv), logits = tiny_step(kv8)
    fargs, fkw = fresh(args, kw, kv8)
    forced = dsk.decode_token_batched_logits_ref(
        *fargs, forced=forced_rows(ck, cv), **fkw)
    assert torch.equal(forced, logits)


def test_kv8_tie_bound_covers_float32_noise():
    """KV8_TIE_STEPS against the float noise it must cover: stories15M's
    new K and V rows (seeded weights, unit-RMS inputs) summed in float32
    in two orders and in float64 differ by at most a sixteenth of it, in
    steps of their int8 quantization (the largest entry's among them,
    which is how far a scale's noise moves a row)."""
    from chip_smoke import CFG, KV8_TIE_STEPS
    from pydynet_tpu_torch.models.llama import Llama

    model = Llama(**CFG, device="cpu",
                  generator=torch.Generator().manual_seed(0)).eval()
    w = model._fused_weights(torch.float32, None)
    g = torch.Generator().manual_seed(1)
    noise = 0.0
    for layer in range(CFG["n_layers"]):
        for _ in range(20):
            x = torch.randn(CFG["embed_dim"], generator=g)
            x = x / x.pow(2).mean().sqrt()
            for wt in (w["wk"][layer], w["wv"][layer]):
                exact = wt.double() @ x.double()
                s = exact.abs().max() / 127
                for got in (torch.mv(wt, x),
                            torch.mv(wt.flip(-1), x.flip(-1))):
                    noise = max(noise, float(
                        ((got.double() - exact).abs() / s).max()))
    assert 0.0 < noise <= KV8_TIE_STEPS / 16


def test_kv8_tie_gap_takes_only_ties():
    """An int8 row that takes the other side of an entry lying on a
    rounding tie, or whose scale is one float32 ulp off, is within
    KV8_TIE_STEPS of the plain one; the same row with its absmax entry, or
    an entry 0.3 steps from a tie, a step off, or an entry two steps off,
    or its scale 2^-9 off (within KV8_SCALE_RTOL), is not (the gap is 0.5,
    0.3, inf and 0.25 steps)."""
    from chip_smoke import KV8_SCALE_RTOL, KV8_TIE_STEPS, kv8_tie_gap

    x = torch.tensor([127.0, 2.5, 40.2, -7.5, 0.0]) / 64
    q, s = dsk.quantize_kv(x)
    assert q.tolist() == [127, 2, 40, -8, 0]  # half to even

    def gap(row, scale=s):  # the row as K, the plain quantization as V
        return kv8_tie_gap([((row, scale), (q, s))], [(x, x)])

    ulp = torch.nextafter(s, torch.tensor(1.0))
    assert gap(q, ulp) <= KV8_TIE_STEPS
    off = s * (1 + 2.0**-9)
    assert 2.0**-9 < KV8_SCALE_RTOL[torch.float32]
    assert gap(q, off) > 0.24

    for i, d in ((1, 1), (3, 1)):
        row = q.clone()
        row[i] += d
        assert gap(row) <= KV8_TIE_STEPS
    for i, d in ((0, -1), (2, 1)):
        row = q.clone()
        row[i] += d
        assert gap(row) > 0.29
    row = q.clone()
    row[1] += 2
    assert gap(row) == float("inf")
    assert gap(q) == 0.0


def test_tie_check_takes_a_kv8_tie_and_rejects_a_non_tie():
    """A kernel's emit step at pos 0, where a row attends to its new cache
    row alone, emulated from the plain version: batch row 1's last-layer
    new V row takes the other side of an entry that lies on a rounding
    tie (its wv row scaled so that x / s = n + 1/2, within float noise).
    Its logits move beyond EMIT_RTOL of the plain step's, and the check
    accepts them through the plain step teacher-forced on the kernel's
    rows. The same row with its absmax entry, or the entry farthest from
    a tie, moved a step instead, or with its scale 2^-9 off (within
    KV8_SCALE_RTOL), is rejected, though teacher forcing would explain
    those logits as well."""
    from chip_smoke import EMIT_RTOL, forced_plain

    args, kw, _, _ = tiny_step(True)

    def plain_rows():  # the plain step on fresh caches: (logits, kv_rows)
        kv = []
        a, k = fresh(args, kw, True)
        return dsk.decode_token_batched_logits_ref(*a, kv_rows=kv, **k), kv

    v = plain_rows()[1][1][-1][1]  # batch row 1, last layer, V
    y = v / (v.abs().max() / 127)
    j = int(torch.argmin((y.abs() - 40.3).abs()))
    wv = args[8]  # (N, Dkv, D), decode_weight_args' order; fresh() keeps it
    wv[-1, j] *= float((torch.floor(y[j]) + 0.5) / y[j])
    plain, kv = plain_rows()
    x = kv[1][-1][1]
    y = x / dsk.quantize_kv(x)[1]
    assert abs(abs(float(y[j])) % 1 - 0.5) < 1e-4
    a, k = fresh(args, kw, True)
    ck, cv = (a[-2], k["sk"]), (a[-1], k["sv"])
    dsk.decode_token_batched_logits_ref(*a, **k)  # the plain caches
    rtol = EMIT_RTOL["f32"] * float(plain.abs().max())

    def errs(got, ref):
        return (got - ref).abs().amax(-1).tolist()

    def check(entry, scale=1.0):
        """The plain caches with the entry moved a step across its value
        (``entry`` None: none) and the row's scale times ``scale``, as a
        kernel's: whether the check takes the kernel's logits, and the
        reference each row took."""
        kcv = (cv[0].clone(), cv[1].clone())
        kcv[1][-1, 1, 0] *= scale
        if entry is not None:
            q = kcv[0][-1, 1, 0]
            q[entry] += 1 if float(y[entry]) > float(q[entry]) else -1
        got = forced_plain(*fresh(args, kw, True), ck, kcv, 0)[0]
        assert errs(got, plain)[1] > rtol

        def forced():
            logits, gaps = forced_plain(*fresh(args, kw, True), ck, kcv, 0)
            return [e if gap <= KV8_TIE_STEPS else float("inf")
                    for e, gap in zip(errs(got, logits), gaps)]

        kept, took = against_plain(errs(got, plain), [forced],
                                   lambda e: e <= rtol)
        return max(kept) <= rtol, took

    assert check(j) == (True, [0, 1, 0])
    far = int(torch.argmin((y - torch.round(y)).abs()
                           + 1e3 * (y.abs() > 126)))
    assert check(int(torch.argmax(x.abs()))) == (False, [0, 0, 0])
    assert check(far) == (False, [0, 0, 0])
    assert check(None, 1 + 2.0**-9) == (False, [0, 0, 0])
