"""The fp32 K6a (csrc/flash_attention_fp32.cu), K6b and K6c
(csrc/flash_attention_fp32_bwd.cu) on the tensor cores, checked on the CPU
where no card is: the arithmetic, the index maps and the split of K6c's
query loop, each against the plain versions that the card tests hold the
kernels to.

- A numpy emulation of K6a's steps: per 64-key tile S in 3xTF32, keys >=
  sk_actual masked, the running max and sum in fp32, P = exp2(S - m), P V
  in 3xTF32 into a fresh accumulator a tile, O = alpha O + PV in fp32, o =
  O / l and lse = m + log2 l, at small Style-DoRA-like shapes (self
  attention, 77 keys padded to 128) within the card's bounds of
  ``flash_fwd_plain``: o within a relative L2 of 1e-5, lse within 1e-5.
- K6a's P V fragments against the pre-pass's permuted V^T, and the
  pre-pass's plain version (``fwd_prep_f32_plain``) and its layout.

- A numpy emulation of the kernels' 3xTF32 products (each operand split as
  hi = rna_tf32(x), lo = rna_tf32(x - hi); hi·hi + hi·lo + lo·hi with fp32
  sums; the long reductions summed a tile at a time, as the kernels add each
  tile's accumulator into registers) run through K6b's and K6c's steps at
  small Style-DoRA-like shapes (self-attention and 77 text keys padded to
  128) within the card's bound: a relative L2 error of 1e-5 against
  ``flash_bwd_dq_plain`` / ``flash_bwd_dkv_plain``.  This shows the
  arithmetic meets the bound before any card run.
- The register A fragment the kernels build from a wgmma accumulator, read
  with PTX's TF32 A layout against the pre-pass's row-permuted transposed
  operand, gives the plain product.
- ``dkv_splits``: every query tile in exactly one split, in order, none
  empty; the 77-key shapes of a DoRA step launch at least 132 CTAs; the
  counts it picks at a DoRA step's four shapes on 132 SMs.
- The split partials summed in split order (``dkv_reduce_plain``) equal
  ``flash_bwd_dkv_plain`` within a relative L2 of 1e-6.
- ``bwd_prep_f32_plain``: TF32 rounding to nearest, ties away from zero;
  the workspace's layout.
"""
import numpy as np
import pytest
import torch

from fairygen_tpu_torch.ops import flash_attention as fa

LOG2E = 1.4426950408889634
H100_SMS = 132


def _rna(x):
    """fp32 -> TF32 (10 mantissa bits), nearest, ties away from zero."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tc(a, b):
    """a (M, K) @ b (K, N) as the kernels take it: three TF32 passes into
    one fp32 sum."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _rna(a), _rna(b)
    al, bl = _rna(a - ah), _rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tiled(a, b, tile):
    """a @ b over the reduced index in tiles: each tile's 3xTF32 product
    from zero, added into an fp32 sum (the kernels' register adds)."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for t0 in range(0, a.shape[1], tile):
        out += _tc(a[:, t0:t0 + tile], b[t0:t0 + tile])
    return out


def _inputs(bn, sq, sk_pad, sk_actual, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bn, sq, 64)) * 64 ** -0.5 * LOG2E).astype(np.float32)
    k, v = (rng.standard_normal((bn, sk_pad, 64)).astype(np.float32) for _ in range(2))
    k[:, sk_actual:], v[:, sk_actual:] = 0, 0
    do = (rng.standard_normal((bn, sq, 64)) * 0.05).astype(np.float32)
    qh, kh, vh, doh = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_fwd_plain(qh, kh, vh, sk_actual=sk_actual)
    delta = (doh * o).sum(-1)
    return q, k, v, do, lse.numpy(), delta.numpy()


def _emulated_dq(q, k, v, do, lse, delta, sk_actual, f):
    """K6b: per 64-key tile S and dP in 3xTF32, P = exp2(S - lse), dS (0
    past sk_actual), dQ += dS K a tile at a time."""
    dq = np.empty_like(q)
    for h in range(q.shape[0]):
        s = _tc(q[h], k[h].T)
        p = np.exp2(s - lse[h][:, None])
        ds = p * (_tc(do[h], v[h].T) - delta[h][:, None])
        ds[:, sk_actual:] = 0
        dq[h] = _tiled(ds, k[h], 64) * np.float32(f)
    return dq


def _emulated_dkv(q, k, v, do, lse, delta, sq, sk_actual):
    """K6c: per 32-query tile S^T and dP^T in 3xTF32, P^T = exp2(S^T - lse)
    (0 at queries >= sq), dS^T, dV += P^T dO and dK += dS^T Q a tile at a
    time; key rows >= sk_actual stored as 0."""
    dk, dv = np.empty_like(k), np.empty_like(v)
    for h in range(q.shape[0]):
        lse_h = np.where(np.arange(q.shape[1]) < sq, lse[h], np.inf).astype(np.float32)
        pt = np.exp2(_tc(k[h], q[h].T) - lse_h[None])
        dst = pt * (_tc(v[h], do[h].T) - np.where(np.isinf(lse_h), 0, delta[h])[None])
        dv[h] = _tiled(pt, do[h], 32)
        dk[h] = _tiled(dst, q[h], 32) * np.float32(1 / LOG2E)
        dk[h, sk_actual:], dv[h, sk_actual:] = 0, 0
    return dk, dv


def _emulated_fwd(q, k, v, sk_actual, tc=None):
    """K6a: per 64-key tile S in 3xTF32, key columns >= sk_actual at -inf,
    the running max m and sum l in fp32, P = exp2(S - m), O = alpha O + P V
    with each tile's P V a fresh 3xTF32 product; o = O / l, lse = m +
    log2(l).  ``tc`` replaces the 3xTF32 product."""
    tc = tc or _tc
    o = np.empty_like(q)
    lse = np.empty(q.shape[:2], np.float32)
    for h in range(q.shape[0]):
        m = np.full(q.shape[1], -np.inf, np.float32)
        l = np.zeros(q.shape[1], np.float32)
        acc = np.zeros(q.shape[1:], np.float32)
        for j0 in range(0, sk_actual, 64):
            s = tc(q[h], k[h, j0:j0 + 64].T)
            s[:, sk_actual - j0:] = -np.inf
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(1, dtype=np.float32)
            acc = acc * alpha[:, None] + tc(p, v[h, j0:j0 + 64])
            m = m_new
        o[h] = acc / l[:, None]
        lse[h] = m + np.log2(l)
    return o, lse


def _one_pass(a, b):
    return _rna(np.asarray(a, np.float32)) @ _rna(np.asarray(b, np.float32))


@pytest.mark.parametrize("sq,sk_pad,sk_actual", [(256, 256, 256), (192, 128, 77),
                                                 (128, 192, 150)])
def test_3xtf32_forward_meets_the_fp32_bound(sq, sk_pad, sk_actual):
    """K6a emulated in 3xTF32 against ``flash_fwd_plain`` (2 heads): o
    within a relative L2 error of 1e-5, lse within 1e-5 absolute; one TF32
    pass alone misses the o bound, so the test can tell."""
    q, k, v, _, _, _ = _inputs(2, sq, sk_pad, sk_actual, seed=sq + sk_actual + 1)
    o_ref, lse_ref = (x.numpy() for x in fa.flash_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), sk_actual=sk_actual))
    o, lse = _emulated_fwd(q, k, v, sk_actual)
    assert o.dtype == np.float32 and _rel_l2(o, o_ref) < 1e-5
    assert np.abs(lse - lse_ref).max() < 1e-5
    assert _rel_l2(_emulated_fwd(q, k, v, sk_actual, _one_pass)[0], o_ref) > 1e-4


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("sq,sk_pad,sk_actual", [(256, 256, 256), (256, 128, 77)])
def test_3xtf32_backward_meets_the_fp32_bound(sq, sk_pad, sk_actual):
    """K6b and K6c emulated in 3xTF32 against their plain fp32 versions
    within a relative L2 error of 1e-5 (2 heads); one TF32 pass alone
    misses the bound, so the test can tell."""
    q, k, v, do, lse, delta = _inputs(2, sq, sk_pad, sk_actual, seed=sq + sk_actual)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    f = 1 / LOG2E
    dq_ref = fa.flash_bwd_dq_plain(*t, sk_actual=sk_actual, dq_factor=f).numpy()
    dk_ref, dv_ref = (x.numpy() for x in fa.flash_bwd_dkv_plain(*t, sq=sq - 5,
                                                                sk_actual=sk_actual))
    dq = _emulated_dq(q, k, v, do, lse, delta, sk_actual, f)
    dk, dv = _emulated_dkv(q, k, v, do, lse, delta, sq - 5, sk_actual)
    for out, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _rel_l2(out, ref) < 1e-5
    assert not dk[:, sk_actual:].any() and not dv[:, sk_actual:].any()
    assert _rel_l2(_emulated_one_pass(q, k, v, do, lse, delta, sk_actual, f), dq_ref) > 1e-4


def _emulated_one_pass(q, k, v, do, lse, delta, sk_actual, f):
    """K6b with every product in one TF32 pass."""
    out = np.empty_like(q)
    for h in range(q.shape[0]):
        p = np.exp2(_rna(q[h]) @ _rna(k[h]).T - lse[h][:, None])
        ds = p * (_rna(do[h]) @ _rna(v[h]).T - delta[h][:, None])
        ds[:, sk_actual:] = 0
        out[h] = (_rna(ds) @ _rna(k[h])) * np.float32(f)
    return out


def _a_fragments(x):
    """The A operand the kernels hand wgmma from a 64 x 64 accumulator x
    (thread (warp w, lane): g = 16w + lane / 4, t = lane % 4; x[4j + e] at
    row g + 8 (e // 2), column 8j + 2t + e % 2) as a[4kk..4kk+3] = x[4kk],
    x[4kk + 2], x[4kk + 1], x[4kk + 3], read with PTX's TF32 A layout (a0
    row g col t, a1 row g + 8 col t, a2 row g col t + 4, a3 row g + 8 col
    t + 4 of each 8-wide k-step): the matrix wgmma multiplies."""
    a = np.zeros((64, 64), np.float32)
    for w in range(4):
        for lane in range(32):
            g, t = 16 * w + lane // 4, lane % 4
            acc = [x[g + 8 * (e // 2), 8 * j + 2 * t + e % 2] for j in range(8)
                   for e in range(4)]
            for kk in range(8):
                frag = (acc[4 * kk], acc[4 * kk + 2], acc[4 * kk + 1], acc[4 * kk + 3])
                a[g, 8 * kk + t], a[g + 8, 8 * kk + t] = frag[0], frag[1]
                a[g, 8 * kk + t + 4], a[g + 8, 8 * kk + t + 4] = frag[2], frag[3]
    return a


def test_register_fragments_and_permuted_operand_give_the_product():
    """The kernels' A fragments (``_a_fragments``) against B = the
    pre-pass's transposed, row-permuted K: the plain product X K."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    kt = rng.standard_normal((64, 64)).astype(np.float32)  # 64 keys x 64 d
    a = _a_fragments(x)
    perm = fa._permuted_rows(64).numpy()
    b_kmajor = kt[perm].T  # the transposed operand: d rows, permuted keys along the row
    np.testing.assert_allclose(a @ b_kmajor.T, x @ kt, rtol=1e-5, atol=1e-5)


def test_pv_fragments_against_the_forward_prep_give_p_v():
    """K6a's P V: P's fragments (``_a_fragments`` of the S accumulator)
    against the forward pre-pass's V^T block (d rows, each 8 keys permuted
    along the row) read as wgmma's K-major B: exactly P V.  The values are
    TF32-exact (hi = x, lo = 0), so the index map alone decides."""
    rng = np.random.default_rng(4)
    p = (rng.integers(0, 64, (64, 64)) / 64).astype(np.float32)
    kh, vh = (torch.from_numpy((rng.integers(-32, 32, (1, 128, 64)) / 8).astype(np.float32))
              for _ in range(2))
    ws = fa.fwd_prep_f32_plain(kh, vh)
    n = vh.numel()
    vt_hi = ws[2 * n:3 * n].view(1, 64, 128)[0].numpy()
    assert not ws[3 * n:].any()
    for tile in range(2):  # the B operand of key tile j: its 64 columns
        b = vt_hi[:, 64 * tile:64 * tile + 64]
        np.testing.assert_array_equal(_a_fragments(p) @ b.T,
                                      p @ vh[0, 64 * tile:64 * tile + 64].numpy())


DORA_SHAPES = [("a", 10, 4096, 4096), ("b", 20, 1024, 1024), ("c", 10, 4096, 128),
               ("d", 20, 1024, 128)]


@pytest.mark.parametrize("tag,bn,sq,sk_pad", DORA_SHAPES + [
    ("tiny self", 1, 1024, 1024), ("tiny cross", 2, 256, 128), ("one tile", 3, 20, 64),
    ("ragged", 4, 1000, 192), ("many heads", 300, 4096, 128), ("full round", 33, 1024, 512)])
def test_dkv_splits_cover_every_query_tile_once(tag, bn, sq, sk_pad):
    n_split, tps = fa.dkv_splits(bn, sq, sk_pad, H100_SMS)
    n_qt = -(-sq // 32)
    ranges = fa.split_ranges(n_qt, n_split, tps)
    assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(n_qt))
    assert all(hi > lo for lo, hi in ranges)
    items = bn * -(-sk_pad // 128) * n_split
    if tag in ("c", "d"):
        assert n_split > 1 and items >= H100_SMS
    if items < H100_SMS:  # fewer items only where no split can make more
        assert n_split == n_qt
    # the model's picks at the DoRA shapes (rounds x (tiles + 2)); 33 heads
    # of 512 keys fill the SMs once, so no split
    want = {"a": (2, 64), "b": (4, 8), "c": (26, 5), "d": (11, 3), "full round": (1, 32)}
    if tag in want:
        assert (n_split, tps) == want[tag]


@pytest.mark.parametrize("bn,sq,sk_pad,sk_actual,n_split,tps", [
    (2, 250, 128, 77, 3, 3), (2, 256, 128, 77, 8, 1), (3, 200, 192, 150, 2, 5)])
def test_split_partials_sum_to_the_plain_dkv(bn, sq, sk_pad, sk_actual, n_split, tps):
    q, k, v, do, lse, delta = _inputs(bn, -(-sq // 64) * 64, sk_pad, sk_actual, seed=bn + sq)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    part = fa.flash_bwd_dkv_partials_plain(*t, sq=sq, sk_actual=sk_actual, n_split=n_split,
                                           tiles_per_split=tps)
    assert part.shape == (n_split, 2, bn, sk_pad, 64)
    dk, dv = fa.dkv_reduce_plain(part)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*t, sq=sq, sk_actual=sk_actual)
    assert _rel_l2(dk, dk_ref) < 1e-6 and _rel_l2(dv, dv_ref) < 1e-6
    assert not dk[:, sk_actual:].any() and not dv[:, sk_actual:].any()


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0e-39, 65504.0 + 17.0], dtype=torch.float32)
    got = fa.tf32_round_plain(x)
    np.testing.assert_array_equal(got.numpy(), _rna(x.numpy()))
    assert got[1] == 1 + 2 ** -10 and got[2] == 1 + 2 ** -9 and got[3] == -(1 + 2 ** -10)
    assert got[4] == 1.0
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("which", [0, 1])
def test_prep_workspace_layout(which):
    """hi + lo gives x back within 2^-21 relative; the transposed block holds
    K^T (K6b) or Q^T, dO^T (K6c), each 8 rows permuted."""
    rng = np.random.default_rng(which)
    bn, sq_p, sk_p = 2, 128, 192
    qh, doh = (torch.from_numpy(rng.standard_normal((bn, sq_p, 64)).astype(np.float32))
               for _ in range(2))
    kh, vh = (torch.from_numpy(rng.standard_normal((bn, sk_p, 64)).astype(np.float32))
              for _ in range(2))
    ws = fa.bwd_prep_f32_plain(qh, kh, vh, doh, which)
    nq, nk = qh.numel(), kh.numel()
    assert ws.numel() == 4 * nq + 4 * nk + (2 * nk if which == 0 else 4 * nq)
    sizes = [nq] * 4 + [nk] * 4 + ([nk] * 2 if which == 0 else [nq] * 4)
    blocks = torch.split(ws, sizes)
    for i, x in enumerate((qh, doh, kh, vh)):
        hi, lo = blocks[2 * i].view_as(x), blocks[2 * i + 1].view_as(x)
        assert torch.equal(hi, fa.tf32_round_plain(x))
        assert ((hi + lo - x).abs() <= 2 ** -21 * x.abs()).all()
    perm = fa._permuted_rows(sq_p if which else sk_p)
    for i, x in enumerate((kh,) if which == 0 else (qh, doh)):
        xt = x[:, perm].transpose(1, 2).contiguous()  # (BN, 64, S_pad): xt[.., d, p] = x[perm p, d]
        hi = blocks[8 + 2 * i].view_as(xt)
        lo = blocks[9 + 2 * i].view_as(xt)
        assert torch.equal(hi, fa.tf32_round_plain(xt))
        assert torch.equal(lo, fa.tf32_round_plain(xt - hi))
    assert perm[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_fwd_prep_workspace_layout():
    """The fp32 K6a pre-pass: K's TF32 hi and lo as K lies, then V^T's
    (BN, 64, Sk_pad) with each 8 keys permuted; hi + lo gives x back within
    2^-21 relative."""
    rng = np.random.default_rng(7)
    kh, vh = (torch.from_numpy(rng.standard_normal((3, 192, 64)).astype(np.float32))
              for _ in range(2))
    ws = fa.fwd_prep_f32_plain(kh, vh)
    n = kh.numel()
    assert ws.numel() == 4 * n
    k_hi, k_lo, vt_hi, vt_lo = torch.split(ws, [n] * 4)
    assert torch.equal(k_hi.view_as(kh), fa.tf32_round_plain(kh))
    assert ((k_hi.view_as(kh) + k_lo.view_as(kh) - kh).abs() <= 2 ** -21 * kh.abs()).all()
    perm = fa._permuted_rows(192)
    vt = vh[:, perm].transpose(1, 2).contiguous()  # vt[.., d, p] = v[perm p, d]
    assert torch.equal(vt_hi.view_as(vt), fa.tf32_round_plain(vt))
    assert torch.equal(vt_lo.view_as(vt), fa.tf32_round_plain(vt - vt_hi.view_as(vt)))
    assert vt_hi.view_as(vt)[1, 5, 1] == fa.tf32_round_plain(vh[1, 2, 5])
