"""What ``ops/csrc/paged_sm90.cu`` takes and how it cuts a call, on the CPU.

No GPU and no JAX: the wrappers' refusal function and the split plan are
pure functions of shapes and types, and a plain-torch simulation of the
kernel's arithmetic (per-split online softmax in base 2 with P rounded to
bf16, the splits merged in split order in fp32) stands in for the kernel
against the plain versions the card holds it to. It is the CPU evidence that
``chip_smoke.py``'s paged limits (``DECODE_TOL`` = ``ROWS_TOL`` = 0.06 of a
row's RMS) pass the new arithmetic with margin and fail a merge that drops
a split.

    python -m pytest tests/test_torch_paged_sm90.py -q
"""

import math

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.ops.paged_attention import (
    ROW_TILE, SUBTILE, paged_decode_attention_torch, paged_refusal,
    paged_spec_verify_attention_torch, split_plan, split_positions, splits_of)
from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

ROWS_TOL = 0.06        # chip_smoke.py's ROWS_TOL and DECODE_TOL
LOG2E = 1.0 / math.log(2.0)


# --------------------------------------------------------------------------- #
# refusal and plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("nh,nkv,hd,ng", [
    (71, 1, 64, 0), (71, 1, 64, 1),        # Falcon-7B: 71 query heads over one kv head
    (32, 8, 128, 0), (32, 8, 128, 1), (32, 8, 128, 4), (32, 8, 128, 8),
    (32, 32, 64, 0), (32, 32, 64, 4), (8, 2, 256, 16)])
def test_refusal_takes_the_kernels_shapes(nh, nkv, hd, ng):
    pool = torch.int8 if ng else torch.bfloat16
    assert paged_refusal(q_dtype=torch.bfloat16, pool_dtype=pool, hd=hd, nh=nh, nkv=nkv,
                         ng=ng) is None


@pytest.mark.parametrize("kw,why", [
    ({"hd": 96}, "head dim 96"),
    ({"hd": 32}, "head dim 32"),
    ({"q_dtype": torch.float16, "pool_dtype": torch.float32}, "q-dtype pools"),
    ({"q_dtype": torch.float32}, "bf16 or fp16 q"),
    ({"pool_dtype": torch.float16}, "q-dtype pools"),
    ({"ng": 8}, "16 lanes"),                     # groups of 8 lanes at hd 64
    ({"ng": 2, "pool_dtype": torch.bfloat16}, "int8 pools"),
    ({"nh": 30}, "multiple of nkv")])
def test_refusal_names_what_the_kernel_does_not_take(kw, why):
    args = {"q_dtype": torch.bfloat16, "pool_dtype": torch.bfloat16, "hd": 64, "nh": 32,
            "nkv": 8, "ng": 0}
    args.update(kw)
    if args["ng"] and "pool_dtype" not in kw:
        args["pool_dtype"] = torch.int8
    got = paged_refusal(**args)
    assert got is not None and why in got, got


def test_split_rule():
    """Splits of whole 16-position subtiles: 4 at least (64 positions), 32 at
    most (512), about 8 splits of a sequence in between."""
    assert SUBTILE == 16 and ROW_TILE == 16
    cases = {0: (1, 64), 1: (1, 64), 64: (1, 64), 65: (2, 64), 512: (8, 64), 513: (7, 80),
             530: (7, 80), 2048: (8, 256), 2049: (8, 272), 4096: (8, 512), 4097: (9, 512),
             8192: (16, 512)}
    for live, (n, span) in cases.items():
        assert (splits_of(live), split_positions(live)) == (n, span), live
        # the splits cover the live positions, the last one non-empty
        assert (n - 1) * span < max(live, 1) <= n * span


@pytest.mark.parametrize("span", [1, 15, 16, 63, 64, 65, 500, 511, 512, 513, 2047, 2048,
                                  2049, 4096, 8192, 8193, 32768])
def test_plan_bounds_every_sequence(span):
    """The scratch is sized for the most splits any live length up to the
    table's span can take."""
    plan = split_plan(1, 1, 1, 1, 64, 1, span)
    assert plan["splits"] == max(splits_of(n) for n in range(span + 1))


@pytest.mark.parametrize("name,args,want", [
    # Llama-3-8B serving: 64 slots, 32/8 heads, hd 128, tables of 64 x 128
    ("llama decode", (64, 1, 32, 8, 128, 128, 64), (4, 1, 16)),
    ("llama verify", (64, 5, 32, 8, 128, 128, 64), (20, 2, 16)),
    # OPT-1.3B: 32/32 heads, hd 64, tables of 16 x 128
    ("opt decode", (64, 1, 32, 32, 64, 128, 16), (1, 1, 8)),
    ("opt verify", (64, 5, 32, 32, 64, 128, 16), (5, 1, 8)),
    # Falcon-7B shapes: 71 heads over one kv head, hd 64
    ("falcon decode", (8, 1, 71, 1, 64, 64, 12), (71, 5, 8)),
    ("falcon verify", (8, 5, 71, 1, 64, 64, 12), (355, 23, 8)),
])
def test_plan_at_the_smokes_shapes(name, args, want):
    B, t, nh, nkv, hd, bs, mb = args
    rows, row_tiles, splits = want
    plan = split_plan(*args)
    assert (plan["rows"], plan["row_tiles"], plan["splits"]) == want, name
    assert plan["counters"] == B * nkv * row_tiles
    assert plan["items_max"] == B * splits * nkv * row_tiles
    assert plan["partials"] == B * splits * nkv * rows * (hd + 2)


def test_plan_with_a_static_window():
    """A static window bounds the live positions at window + t - 1."""
    full = split_plan(64, 5, 32, 8, 128, 128, 64)
    short = split_plan(64, 5, 32, 8, 128, 128, 64, window=100)
    assert full["splits"] == 16 and short["splits"] == 2
    assert split_plan(64, 1, 32, 8, 128, 128, 64, window=60)["partials"] == 0


# --------------------------------------------------------------------------- #
# the kernel's arithmetic, simulated
# --------------------------------------------------------------------------- #
def _bf16(x):
    return x.to(torch.bfloat16).float()


def simulate(q4, k_pool, v_pool, tables, ctx, *, window=None, k_scale=None, v_scale=None,
             drop_last_split=False):
    """The kernel's arithmetic in plain torch, fp32: each split walks its
    positions 16 at a time with an online softmax in base 2, P rounded to
    bf16 before P V (int8 at one scale per vector: P times the V scale,
    scores times the K scale; more groups: code x scale rounded to bf16),
    and the splits merge in split order. Returns [B, t, nh, hd] fp32."""
    B, t, nh, hd = q4.shape
    num_blocks, nkv, bs, _ = k_pool.shape
    g, cap, scale = nh // nkv, tables.shape[1] * bs, hd ** -0.5
    quant = k_scale is not None
    ng = k_scale.shape[-1] if quant else 0
    out = torch.zeros(B, t, nh, hd)
    for b in range(B):
        c = int(ctx[b])
        lo = max(c - window + 1, 0) if window else 0
        hi = min(c + t, cap)
        span = split_positions(hi - lo)
        ns = splits_of(hi - lo)
        pos = torch.arange(lo, max(hi, lo))
        blk = tables[b, pos // bs].long().clamp(0, num_blocks - 1)
        row = pos % bs
        for h in range(nkv):
            k = k_pool[blk, h, row].float()              # [n, hd] (codes in int8 mode)
            v = v_pool[blk, h, row].float()
            if quant:
                ks, vs = k_scale[blk, h, row], v_scale[blk, h, row]     # [n, ng]
                if ng > 1:
                    k = _bf16((k.view(-1, ng, hd // ng) * ks[..., None]).view(-1, hd))
                    v = _bf16((v.view(-1, ng, hd // ng) * vs[..., None]).view(-1, hd))
            # rows g-major, t-minor: query head h*g + gi at step ti
            qr = q4[b, :, h * g:(h + 1) * g].float().permute(1, 0, 2).reshape(g * t, hd)
            lim = c + torch.arange(t).repeat(g)          # row r sits at ctx + r % t
            parts = []
            for s in range(ns):
                m = torch.full((g * t,), -math.inf)
                l = torch.zeros(g * t)
                acc = torch.zeros(g * t, hd)
                for p0 in range(s * span, min((s + 1) * span, hi - lo), SUBTILE):
                    sl = slice(p0, min(p0 + SUBTILE, hi - lo))
                    sc = qr @ k[sl].T
                    if quant and ng == 1:
                        sc = sc * ks[sl, 0]
                    sc = sc * (scale * LOG2E)
                    p_abs = pos[sl][None, :]
                    ok = p_abs <= lim[:, None]
                    if window:
                        ok &= p_abs > lim[:, None] - window
                    sc = torch.where(ok, sc, -math.inf)
                    m_new = torch.maximum(m, sc.max(1).values)
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(sc - m_use[:, None])
                    l = l * alpha + p.sum(1)
                    pw = p * vs[sl, 0] if quant and ng == 1 else p
                    acc = acc * alpha[:, None] + _bf16(pw) @ v[sl]
                    m = m_new
                parts.append((m, l, acc))
            if drop_last_split and ns > 1:
                parts = parts[:-1]
            M = torch.full((g * t,), -math.inf)
            L = torch.zeros(g * t)
            O = torch.zeros(g * t, hd)
            for m, l, acc in parts:
                Mn = torch.maximum(M, m)
                Mu = torch.where(Mn == -math.inf, 0.0, Mn)
                fo, fn = torch.exp2(M - Mu), torch.exp2(m - Mu)
                L = L * fo + l * fn
                O = O * fo[:, None] + acc * fn[:, None]
                M = Mn
            O = O / torch.where(L == 0, 1.0, L)[:, None]
            out[b, :, h * g:(h + 1) * g] = O.view(g, t, hd).permute(1, 0, 2)
    return out


def _row_err(got, ref, rows=None):
    """max over rows of max |got - ref| / RMS(ref row) (rows: a mask over B)."""
    got, ref = got.float(), ref.float()
    if rows is not None:
        got, ref = got[rows], ref[rows]
    diff = (got - ref).abs().amax(-1)
    rms = ref.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float((diff / rms).max())


def _case(seed, t, ng, ctx):
    """A reduced Llama-3-8B serving shape: 32/8 heads, hd 128, blocks of 16;
    pools from randn (int8: the port's own quantizer)."""
    rs = np.random.RandomState(seed)
    nblocks, nkv, bs, hd, nh, mb = 64, 8, 16, 128, 32, 48
    B = len(ctx)
    kf = torch.from_numpy(rs.randn(nblocks, nkv, bs, hd).astype(np.float32))
    vf = torch.from_numpy(rs.randn(nblocks, nkv, bs, hd).astype(np.float32))
    sc = {}
    if ng:
        (kp, ks), (vp, vs) = kv_quantize_int8(kf, hd // ng), kv_quantize_int8(vf, hd // ng)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = kf.bfloat16(), vf.bfloat16()
    tables = torch.from_numpy(rs.randint(1, nblocks, (B, mb)).astype(np.int32))
    ctx = torch.tensor(ctx, dtype=torch.int32)
    tables[ctx == 0] = 0
    q = torch.from_numpy(rs.randn(B, t, nh, hd).astype(np.float32)).bfloat16()
    return q, kp, vp, tables, ctx, sc


# live lengths across the split rule: one split, two, seven of 80, the
# table's end (48 blocks of 16 = 768 positions)
CTX = [0, 40, 64, 200, 508, 700, 763]


@pytest.mark.parametrize("t,ng", [(5, 0), (5, 1), (5, 4), (1, 0), (1, 1), (1, 4)])
@pytest.mark.parametrize("window", [None, 300])
def test_limits_separate_sound_from_faulty(t, ng, window):
    """The simulated kernel reads within half of ROWS_TOL of the plain
    version the card holds it to (bf16 and int8 pools, decode and verify,
    with and without a window), while a merge that drops each sequence's
    last split reads above ROWS_TOL on the rows that have one."""
    q, kp, vp, tables, ctx, sc = _case(7 * t + ng, t, ng, CTX)
    if t == 1:
        ref = paged_decode_attention_torch(q[:, 0], kp, vp, tables, ctx, window=window,
                                           **sc)[:, None]
    else:
        ref = paged_spec_verify_attention_torch(q, kp, vp, tables, ctx, window=window, **sc)
    sound = simulate(q, kp, vp, tables, ctx, window=window, **sc)
    assert _row_err(sound, ref) < ROWS_TOL / 2
    faulty = simulate(q, kp, vp, tables, ctx, window=window, drop_last_split=True, **sc)
    cap = tables.shape[1] * kp.shape[2]
    multi = torch.tensor([splits_of(min(int(c) + t, cap) - (max(int(c) - window + 1, 0)
                                                            if window else 0)) > 1
                          for c in ctx])
    assert multi.any()
    assert _row_err(faulty, ref, multi) > ROWS_TOL
