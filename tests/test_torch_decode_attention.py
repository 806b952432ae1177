"""The CUDA ``decode_attention_quant`` kernel's decomposition, emulated on
the CPU: its lane maps and its arithmetic, held against the plain version
(``decode_attention_quant_ref``) and, where a case pins the semantics, the
JAX package's oracle. The kernel itself runs only on the card
(``test_torch_cuda_kernels.py``).

* the butterfly that sums a warp's 32 (row, slot) partial dot products so
  that lane l ends with pair l;
* the kernel's split of S into blocks, warps and batches of slots, with an
  online softmax a warp, the warp merge in warp order and the split combine
  in split order (torch, f32), against the one-sweep plain version:
  chooser geometries and forced ones, a row that sees no slot, and splits
  whose slots are all masked.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention.ref import \
    decode_attention_quant_ref as jdaq_ref
from repro.serve import cache as jcache

from repro_torch.kernels.decode_attention import decode_attention as daq
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_quant_ref, dequant_kv_ref)
from repro_torch.models import layers as tl
from repro_torch.models.layers import quantise_kv
from repro_torch.serve.cache import kv_bits, kv_codebook


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_butterfly_leaves_lane_l_with_pair_l(seed):
    """csrc ``butterfly<32>``: 32 lanes with 32 values each; at offset H a
    lane keeps the half of its values whose index bit H equals its lane bit
    and adds its partner's copy of that half."""
    x = np.random.default_rng(seed).standard_normal((32, 32))
    lanes = np.arange(32)
    n = 32
    while n > 1:
        h = n // 2
        up = (lanes & h) != 0
        send = np.where(up[:, None], x[:, :h], x[:, h:n])
        keep = np.where(up[:, None], x[:, h:n], x[:, :h])
        x = keep + send[lanes ^ h]
        n = h
    want = np.random.default_rng(seed).standard_normal((32, 32)).sum(0)
    np.testing.assert_allclose(x[:, 0], want, rtol=1e-12, atol=1e-12)


def _merge(parts):
    """(m, l, acc) partials merged in list order: M = max m, weights
    exp(m - M) (0 where m is -inf), l and acc summed with those weights."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - M))
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def emulate_rows_kernel(q, kc, ks, vc, vs, cb, qpos, window, ring, bits,
                        geo):
    """csrc ``attn_rows_kernel`` in torch f32: per group (b, kv head, tile
    of ``geo.row_tile`` query rows) and split, each warp walks batches of
    ``32 // row_tile`` slots (batch ``b0 + w``, ``b0 + w + warps``, ...)
    with an online softmax; scores are (q . codebook[k codes]) * k scale *
    hd^-0.5, -1e30 where masked, -inf past S; the V scale rides on p. The
    warps merge in warp order, the splits in split order."""
    B, T, H, hd = q.shape
    S, K = kc.shape[1], kc.shape[2]
    G = H // K
    ones = torch.ones_like(ks)
    kf = dequant_kv_ref(kc, ones, cb, bits)
    vf = dequant_kv_ref(vc, ones, cb, bits)
    mask = tl.attention_mask(qpos, S, window=window, ring=ring)[:, :, 0, 0]
    RT, PB = geo.row_tile, 32 // geo.row_tile
    nb = -(-S // PB)
    qf = q.float()
    out = torch.zeros(B, T, H, hd)
    for b in range(B):
        for k in range(K):
            for rt in range(geo.row_tiles):
                rows = range(rt * RT, min(T * G, rt * RT + RT))
                ts = [r // G for r in rows]
                hs = [k * G + r % G for r in rows]
                qr = qf[b, ts, hs]
                parts = []
                for sp in range(geo.splits):
                    b0 = nb * sp // geo.splits
                    b1 = nb * (sp + 1) // geo.splits
                    warps = []
                    for w in range(geo.warps):
                        m = torch.full((len(ts),), -torch.inf)
                        l = torch.zeros(len(ts))
                        acc = torch.zeros(len(ts), hd)
                        for bb in range(b0 + w, b1, geo.warps):
                            sl = torch.arange(bb * PB, bb * PB + PB)
                            ok = sl < S
                            sl = sl.clamp(max=S - 1)
                            x = (qr @ kf[b, sl, k].T) * ks[b, sl, k, 0] \
                                * hd ** -0.5
                            sc = torch.where(mask[b, ts][:, sl], x,
                                             torch.tensor(-1e30))
                            sc = torch.where(ok, sc, torch.tensor(-torch.inf))
                            m_new = torch.maximum(m, sc.amax(1))
                            p = torch.where(sc == -torch.inf,
                                            torch.zeros_like(sc),
                                            torch.exp(sc - m_new[:, None]))
                            corr = torch.where(m == -torch.inf,
                                               torch.zeros_like(m),
                                               torch.exp(m - m_new))
                            l = l * corr + p.sum(1)
                            m = m_new
                            pv = p * torch.where(ok, vs[b, sl, k, 0], 0.0)
                            acc = acc * corr[:, None] + pv @ vf[b, sl, k]
                        warps.append((m, l, acc))
                    parts.append(_merge(warps))
                _, L, A = _merge(parts)
                out[b, ts, hs] = A / L.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


# name: (B, T, H, K, hd, S, window, ring, first positions (B,), geometry
# (warps, splits) forced, or None for the chooser's)
EMU_CASES = {
    "decode_ring": (2, 1, 4, 1, 16, 40, 24, True, [47, 9], None),
    "decode_ring_splits": (2, 1, 4, 1, 16, 40, 24, True, [47, 9], (2, 3)),
    "decode_linear_splits": (2, 1, 4, 2, 32, 64, 0, False, [63, 5], (1, 5)),
    "chunk_two_tiles": (2, 3, 4, 1, 16, 48, 0, False, [40, 0], (2, 4)),
    "masked_splits": (1, 1, 4, 1, 16, 96, 0, False, [6], (1, 6)),
    "row_sees_no_slot": (2, 1, 4, 1, 16, 24, 4, False, [40, 10], (1, 2)),
    "ring_unwritten": (2, 2, 4, 2, 16, 32, 16, True, [3, 70], (2, 3)),
}


def emu_inputs(name, fmt, dtype=torch.float32):
    B, T, H, K, hd, S, window, ring, starts, forced = EMU_CASES[name]
    rng = np.random.default_rng(list(EMU_CASES).index(name))
    cb = kv_codebook(fmt)
    caches = []
    for _ in range(2):
        dense = torch.from_numpy(
            rng.standard_normal((B, S, K, hd)).astype(np.float32))
        caches += list(quantise_kv(dense, cb, kv_bits(fmt)))
    q = torch.from_numpy((rng.standard_normal((B, T, H, hd)) * 2).astype(
        np.float32)).to(dtype)
    qp = torch.tensor(starts, dtype=torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32)
    geo = daq.geometry(B, T, H, K, S, 132)
    if forced is not None:
        geo = geo._replace(warps=forced[0], splits=forced[1])
    return (q, *caches, cb, qp), dict(window=window, ring=ring,
                                      bits=kv_bits(fmt)), geo


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("name", list(EMU_CASES))
def test_kernel_emulation_matches_plain_version(name, fmt):
    """f32: 1e-5 relative, the summation order being the only difference."""
    args, kw, geo = emu_inputs(name, fmt)
    got = emulate_rows_kernel(*args, kw["window"], kw["ring"], kw["bits"],
                              geo)
    want = decode_attention_quant_ref(*args, **kw)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_masked_splits_case_has_whole_splits_masked():
    """The case really has splits with no visible slot for its one row:
    their partials enter the combine with weight 0."""
    args, kw, geo = emu_inputs("masked_splits", "q8")
    S, qp = args[1].shape[1], int(args[6][0, 0])
    PB = 32 // geo.row_tile
    nb = -(-S // PB)
    first_slots = [nb * sp // geo.splits * PB for sp in range(geo.splits)]
    assert sum(s0 > qp for s0 in first_slots) >= 4


@pytest.mark.parametrize("fmt", ["q8", "q4"])
def test_row_that_sees_no_slot_is_the_mean_of_v(fmt):
    """Window 4 at position 40 of a 24-slot linear cache: no slot is
    visible, every score is -1e30, and the reference (JAX and the port)
    gives the mean of V, which the kernel's arithmetic keeps."""
    args, kw, geo = emu_inputs("row_sees_no_slot", fmt)
    q, kc, ks, vc, vs, cb, qp = args
    want = jdaq_ref(jnp.asarray(q.numpy()), *(jnp.asarray(a.numpy()) for a
                                              in (kc, ks, vc, vs)),
                    jcache.kv_codebook(fmt), jnp.asarray(qp.numpy()),
                    window=kw["window"], ring=False, bits=kw["bits"])
    mean_v = dequant_kv_ref(vc, vs, cb, kw["bits"])[0].mean(0)  # (K, hd)
    np.testing.assert_allclose(np.asarray(want)[0, 0], mean_v.expand(
        4, -1).numpy(), rtol=1e-5, atol=1e-6)
    got = emulate_rows_kernel(*args, kw["window"], False, kw["bits"], geo)
    torch.testing.assert_close(got[0, 0], mean_v.expand(4, -1), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The tensor-core kernel (csrc attn_mma_kernel), lane by lane


def mma_m16n8k16(a, b, c):
    """PTX mma.m16n8k16 .row.col on fragments, lane = 4g + t: ``a`` (32, 4,
    2), register r's halves (lo, hi): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t,
    2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; ``b`` (32, 2, 2):
    b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; ``c`` (32, 4): c0 = C[g][2t],
    c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]. Returns c + A B in
    the same layout."""
    A, B, C = np.zeros((16, 16)), np.zeros((16, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, 2 * t:2 * t + 2] = a[lane, 0]
        A[g + 8, 2 * t:2 * t + 2] = a[lane, 1]
        A[g, 2 * t + 8:2 * t + 10] = a[lane, 2]
        A[g + 8, 2 * t + 8:2 * t + 10] = a[lane, 3]
        B[2 * t:2 * t + 2, g] = b[lane, 0]
        B[2 * t + 8:2 * t + 10, g] = b[lane, 1]
        C[g, 2 * t:2 * t + 2] = c[lane, 0:2]
        C[g + 8, 2 * t:2 * t + 2] = c[lane, 2:4]
    D = C + A @ B
    out = np.zeros((32, 4))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[lane] = [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                     D[g + 8, 2 * t + 1]]
    return out


def _le_words(byts):
    """Little-endian 32-bit words of a byte row (zero-padded)."""
    byts = np.concatenate([byts, np.zeros(-len(byts) % 4, np.uint8)])
    return byts.view("<u4").astype(np.int64)


def emulate_mma_kernel(q, kc, ks, vc, vs, cb, qpos, window, ring, bits,
                       splits=1, round_bf16=False):
    """csrc ``attn_mma_kernel`` lane by lane (numpy): the q tile staged in
    its padded quarter layout, each lane's K codes (its slot g's quarter t,
    as 32-bit words) and V codes (slots 16ks + 2t, 2t+1, 2t+8, 2t+9, NTW
    columns d = w*8*NTW + g*NTW + i), fragments built as the kernel builds
    them and multiplied by ``mma_m16n8k16``; the online softmax over the 8
    warps, P times the V scale into the P.V A operand, the split combine.
    ``round_bf16`` rounds what the kernel rounds (q, the codebook entries,
    P) to bf16, else every value stays f32 so that the maps are checked
    exactly."""
    B, T, H, HD = q.shape
    S, K = kc.shape[1], kc.shape[2]
    G, NTW = H // K, HD // 64
    CHW, KSTEPS = HD // 4, HD // 16
    CWP = CHW // 2 + 2
    rows_all = T * G

    def rnd(x):
        x = np.asarray(x, np.float32)
        if not round_bf16:
            return x
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    qf = rnd(q.float().numpy())
    tbl = rnd(cb.numpy())
    kcn, vcn = kc.numpy(), vc.numpy()
    ksn, vsn = ks.numpy()[..., 0], vs.numpy()[..., 0]
    mask = tl.attention_mask(qpos, S, window=window, ring=ring)[:, :, 0, 0] \
        .numpy()
    n_chunks = -(-S // 64)
    out = np.zeros((B, T, H, HD), np.float32)

    def code_at(w, i):
        return (int(w) >> (bits * i)) & (0xF if bits == 4 else 0xFF)

    for b in range(B):
        for k in range(K):
            for r0 in range(0, rows_all, 16):
                n_rows = min(16, rows_all - r0)
                rows = [r0 + r for r in range(n_rows)]
                # q tile in its padded layout: word (r, quarter*CWP + off/2)
                q_s = np.zeros((16, 4 * CWP, 2), np.float32)
                for r, row in enumerate(rows):
                    qr = qf[b, row // G, k * G + row % G]
                    for e0 in range(0, HD, 2):
                        q_s[r, (e0 // CHW) * CWP + (e0 % CHW) // 2] = \
                            qr[e0:e0 + 2]
                parts = []
                for sp in range(splits):
                    m_run = np.full(16, -np.inf)
                    l_run = np.zeros(16)
                    o = np.zeros((8, 32, NTW, 4))
                    for c in range(n_chunks * sp // splits,
                                   n_chunks * (sp + 1) // splits):
                        s0 = 64 * c
                        sc = np.full((8, 32, 2, 2), -np.inf)
                        for w in range(8):
                            sacc = np.zeros((32, 4))
                            for j in range(KSTEPS):
                                a = np.zeros((32, 4, 2))
                                bb = np.zeros((32, 2, 2))
                                for lane in range(32):
                                    g, t = lane >> 2, lane & 3
                                    a[lane, 0] = q_s[g, t * CWP + 2 * j]
                                    a[lane, 2] = q_s[g, t * CWP + 2 * j + 1]
                                    a[lane, 1] = q_s[g + 8, t * CWP + 2 * j]
                                    a[lane, 3] = q_s[g + 8,
                                                     t * CWP + 2 * j + 1]
                                    s = s0 + 8 * w + g
                                    kw = 0
                                    if s < S:
                                        qb = CHW if bits == 8 else CHW // 2
                                        words = _le_words(
                                            kcn[b, s, k, t * qb:(t + 1) * qb])
                                        kw = words[j] if bits == 8 else \
                                            (words[j >> 1] >> (16 * (j & 1))) \
                                            & 0xFFFF
                                    v = [tbl[code_at(kw, i)] for i in
                                         range(4)]
                                    bb[lane, 0], bb[lane, 1] = v[0:2], v[2:4]
                                sacc = mma_m16n8k16(a, bb, sacc)
                            for lane in range(32):
                                g, t = lane >> 2, lane & 3
                                for h in range(2):
                                    for e in range(2):
                                        slot = s0 + 8 * w + 2 * t + e
                                        r = g + 8 * h
                                        if slot >= S or r >= n_rows:
                                            continue
                                        row = rows[r]
                                        sc[w, lane, h, e] = (
                                            sacc[lane, 2 * h + e]
                                            * ksn[b, slot, k] * HD ** -0.5
                                            if mask[b, row // G, slot]
                                            else -1e30)
                        # row maxima and sums over the warps, P into p_s
                        p_s = np.zeros((16, 32, 2))
                        corr = np.zeros(16)
                        l_chunk = np.zeros(16)
                        for r in range(16):
                            g, h = r % 8, r // 8
                            lanes = [4 * g + t for t in range(4)]
                            cm = sc[:, lanes, h, :].max()
                            m_new = max(m_run[r], cm)
                            corr[r] = 0.0 if m_run[r] == -np.inf else \
                                np.exp(m_run[r] - m_new)
                            m_run[r] = m_new
                            for w in range(8):
                                for t in range(4):
                                    p = [0.0 if sc[w, 4 * g + t, h, e] ==
                                         -np.inf else
                                         np.exp(sc[w, 4 * g + t, h, e]
                                                - m_new) for e in range(2)]
                                    l_chunk[r] += p[0] + p[1]
                                    for e in range(2):
                                        slot = s0 + 8 * w + 2 * t + e
                                        vsc = vsn[b, slot, k] if slot < S \
                                            else 0.0
                                        p_s[r, 4 * w + t, e] = rnd(p[e] * vsc)
                        l_run = l_run * corr + l_chunk
                        for w in range(8):
                            for lane in range(32):
                                g = lane >> 2
                                o[w, lane, :, 0:2] *= corr[g]
                                o[w, lane, :, 2:4] *= corr[g + 8]
                            for ks_ in range(4):
                                a = np.zeros((32, 4, 2))
                                for lane in range(32):
                                    g, t = lane >> 2, lane & 3
                                    a[lane, 0] = p_s[g, 8 * ks_ + t]
                                    a[lane, 1] = p_s[g + 8, 8 * ks_ + t]
                                    a[lane, 2] = p_s[g, 8 * ks_ + 4 + t]
                                    a[lane, 3] = p_s[g + 8, 8 * ks_ + 4 + t]
                                for i in range(NTW):
                                    bb = np.zeros((32, 2, 2))
                                    for lane in range(32):
                                        g, t = lane >> 2, lane & 3
                                        d0 = w * 8 * NTW + g * NTW
                                        vals = []
                                        for u in range(4):
                                            s = s0 + 16 * ks_ + 2 * t + \
                                                (u & 1) + 8 * (u >> 1)
                                            vw = 0
                                            if s < S and bits == 8:
                                                vw = int.from_bytes(
                                                    vcn[b, s, k, d0:d0 + NTW]
                                                    .tobytes(), "little")
                                            elif s < S:
                                                byts = vcn[b, s, k, d0 // 2:
                                                           d0 // 2 + max(
                                                               1, NTW // 2)]
                                                vw = int.from_bytes(
                                                    byts.tobytes(), "little")
                                                if NTW == 1:
                                                    vw = (vw >> (4 * (d0 & 1))
                                                          ) & 0xF
                                            vals.append(tbl[code_at(vw, i)])
                                        bb[lane, 0] = vals[0:2]
                                        bb[lane, 1] = vals[2:4]
                                    o[w, :, i] = mma_m16n8k16(a, bb,
                                                              o[w, :, i])
                    acc = np.zeros((16, HD))
                    for w in range(8):
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            for i in range(NTW):
                                for h in range(2):
                                    for e in range(2):
                                        d = w * 8 * NTW + (2 * t + e) * NTW \
                                            + i
                                        acc[g + 8 * h, d] = o[w, lane, i,
                                                              2 * h + e]
                    parts.append((torch.from_numpy(m_run),
                                  torch.from_numpy(l_run),
                                  torch.from_numpy(acc)))
                _, L, A = _merge(parts)
                res = (A / L.clamp(min=1e-30)[:, None]).numpy()
                for r, row in enumerate(rows):
                    out[b, row // G, k * G + row % G] = res[r]
    return torch.from_numpy(out)


# name: (B, T, H, K, hd, S, window, ring, first positions (B,), splits)
MMA_CASES = {
    "hd64_two_tiles": (1, 5, 4, 1, 64, 70, 0, False, [60], 1),
    "hd128_ring_splits": (1, 4, 4, 1, 128, 72, 40, True, [100], 2),
    "hd256_k2_window": (2, 8, 4, 2, 256, 64, 20, False, [40, 3], 1),
    "hd64_row_sees_no_slot": (1, 4, 4, 1, 64, 24, 4, False, [40], 1),
}


def mma_inputs(name, fmt):
    B, T, H, K, hd, S, window, ring, starts, splits = MMA_CASES[name]
    rng = np.random.default_rng(100 + list(MMA_CASES).index(name))
    cb = kv_codebook(fmt)
    caches = []
    for _ in range(2):
        dense = torch.from_numpy(
            rng.standard_normal((B, S, K, hd)).astype(np.float32))
        caches += list(quantise_kv(dense, cb, kv_bits(fmt)))
    q = torch.from_numpy((rng.standard_normal((B, T, H, hd)) * 2).astype(
        np.float32))
    qp = torch.tensor(starts, dtype=torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32)
    return (q, *caches, cb, qp), dict(window=window, ring=ring,
                                      bits=kv_bits(fmt)), splits


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_mma_lane_maps_match_plain_version(name, fmt):
    """Every value kept in f32: the QK^T and P.V fragment maps, the q
    staging, the code extraction and the output map are exact, so the
    emulation meets the f32 plain version at 1e-5 relative."""
    args, kw, splits = mma_inputs(name, fmt)
    got = emulate_mma_kernel(*args, kw["window"], kw["ring"], kw["bits"],
                             splits)
    want = decode_attention_quant_ref(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("fmt", ["q8", "q4"])
def test_mma_bf16_rounding_within_kernel_tolerance(fmt):
    """With the kernel's bf16 roundings (q, codebook entries, P times the V
    scale) the emulation stays within the card test's bf16 tolerance of
    the plain version on bf16 q (2e-2 of max|out|)."""
    args, kw, splits = mma_inputs("hd256_k2_window", fmt)
    q = args[0].to(torch.bfloat16)
    got = emulate_mma_kernel(q, *args[1:], kw["window"], kw["ring"],
                             kw["bits"], splits, round_bf16=True)
    want = decode_attention_quant_ref(q, *args[1:], **kw).float()
    torch.testing.assert_close(got, want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))
