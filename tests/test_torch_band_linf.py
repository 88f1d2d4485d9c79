"""K9a, the band build's linf score fused with its filter and epilogue,
on the CPU: the plain versions that CPU tensors take (the bins of
``_band_bins_sym_plain``, their per-row histogram ``_band_hist_sym`` and
``_band_keep2_dense`` under "linf") held bit for bit against the JAX
package's ``_band_bins_sym`` and ``_band_keep2_dense``; the thresholds
from the histogram (``_band_thr_from_hist``, the card's pass 1) against
the bisection of the bins (``_band_thr_from_bins``) of both packages;
the packed near-anchor bits against ``shared_anchor_counts``; a numpy
model of the kernel's own arithmetic (popcount admission, one rounded
product truncated, the histogram, the threshold compare) against the JAX
package; the dispatch and the wrapper's checks.  The kernel itself runs on the card:
``tests/test_torch_cuda.py`` (``test_k9a_*``) and ``chip_smoke.py``
phase 2.

The JAX package does not mask padding columns (ROADMAP F6): a row whose
effective threshold is 0 admits them there.  Where a case has both, the
comparison covers the real columns and the port's padding columns must
hold no candidate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annchor_tpu.ops import locality as jloc
from annchor_tpu_torch.ops import band_linf_cuda
from annchor_tpu_torch.ops import locality as tloc
from annchor_tpu_torch.ops.band_linf_cuda import K9A
from annchor_tpu_torch.ops.features import anchor_membership, shared_anchor_counts

torch.set_num_threads(2)

NBINS = 256
NX = 300
BLOCK = 128  # band rows and column chunk: nxp 384, so 84 padding points


def _problem(na, zero_thr, pad, seed):
    """The build's padded operands as ``candidate_pairs_device_budgeted``
    makes them: D32p (nxp, na), Sp, effp (+inf on padding), inv_bin,
    and a pass-2 threshold vector with zeros and +inf.  Distances are
    integers and arbitrary float32s, so bins and thresholds tie."""
    rng = np.random.default_rng(na * 10 + zero_thr + 2 * pad)
    nx = NX if pad else 2 * BLOCK
    nxp = -(-nx // BLOCK) * BLOCK
    D = np.where(rng.random((nx, na)) < 0.5, rng.integers(0, 60, (nx, na)),
                 rng.random((nx, na)) * 60).astype(np.float32)
    S, _ = anchor_membership(D, min(5, na), "cpu")
    eff = rng.integers(1, 4, nx).astype(np.float32)
    if zero_thr:
        eff[rng.random(nx) < 0.1] = 0.0
    lb_max = float(2.0 * D.max()) + 1e-6
    thr = rng.choice(np.array([0.0, 5.0, 12.5, 20.0, 40.0, np.inf], dtype=np.float32), nxp)
    p = nxp - nx
    return dict(
        nx=nx, nxp=nxp,
        D32p=np.pad(D, ((0, p), (0, 0))), Sp=np.pad(S.numpy(), ((0, p), (0, 0))),
        effp=np.pad(eff, (0, p), constant_values=np.inf),
        inv_bin=np.float32(NBINS / lb_max), thr=thr,
    )


def _band(P, r0):
    r1 = r0 + BLOCK
    return P["Sp"][r0:r1], P["D32p"][r0:r1], P["effp"][r0:r1]


def _torch_args(P, r0):
    Sb, Db, eb = _band(P, r0)
    t = torch.as_tensor
    return (t(P["D32p"]), t(P["Sp"]), t(Sb), t(Db), t(eb), t(P["effp"]), r0, P["nx"],
            t(P["inv_bin"]), NBINS, BLOCK)


def _torch_bins(P, r0):
    return tloc._band_bins_sym_plain(*_torch_args(P, r0)).numpy()


def _torch_hist(P, r0):
    return tloc._band_hist_sym(*_torch_args(P, r0)).numpy()


def _bincount_rows(bins):
    """int32 (B, NBINS): per-row counts of the bins below the sentinel."""
    return np.stack([np.bincount(r[r < NBINS], minlength=NBINS) for r in bins]).astype(np.int32)


def _jax_bins(P, r0):
    Sb, Db, eb = _band(P, r0)
    j = jnp.asarray
    return np.asarray(jloc._band_bins_sym(
        j(P["D32p"]), j(P["Sp"]), j(Sb), j(Db), j(eb), j(P["effp"]), r0,
        j(P["inv_bin"]), NBINS, BLOCK, "linf"))


def _torch_keep(P, r0):
    Sb, Db, eb = _band(P, r0)
    t = torch.as_tensor
    keep, rowcnt, colcnt = tloc._band_keep2_dense(
        t(P["D32p"]), t(P["Sp"]), t(Sb), t(Db), t(eb), t(P["effp"]), t(P["thr"]), r0,
        P["nx"], BLOCK)
    np.testing.assert_array_equal(rowcnt.numpy(), keep.numpy().sum(axis=1))
    np.testing.assert_array_equal(colcnt.numpy(), keep.numpy().sum(axis=0))
    return keep.numpy()


def _jax_keep(P, r0):
    Sb, Db, eb = _band(P, r0)
    j = jnp.asarray
    keep = jloc._band_keep2_dense(j(P["D32p"]), j(P["Sp"]), j(Sb), j(Db), j(eb),
                                  j(P["effp"]), j(P["thr"]), r0, BLOCK, "linf")[0]
    return np.asarray(keep)


def _assert_as_jax(got, want, P, mode):
    """Bit-equal on every column when nothing differs by F6; otherwise on
    the real columns, with no candidate among the port's padding."""
    nx = P["nx"]
    if nx == P["nxp"] or not (P["effp"][:nx] == 0).any():
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got[:, :nx], want[:, :nx])
    pad = got[:, nx:]
    assert (pad == NBINS).all() if mode == "bins" else not pad.any()


CASES = [(na, zero, pad) for na in (5, 32, 48, 96) for zero, pad in
         ((False, True), (True, True), (True, False))]
IDS = ["na%d-%s-%s" % (na, "zero-thr" if z else "thr", "pad" if p else "nopad")
       for na, z, p in CASES]


@pytest.mark.parametrize("na,zero_thr,pad", CASES, ids=IDS)
def test_band_passes_bit_equal_to_jax(na, zero_thr, pad):
    """Both passes of every band (the last one ragged with padding rows
    when ``pad``), the diagonal and the thresholds' zeros and +inf."""
    P = _problem(na, zero_thr, pad, seed=na)
    before = K9A.launches
    for r0 in range(0, P["nxp"], BLOCK):
        _assert_as_jax(_torch_bins(P, r0), _jax_bins(P, r0), P, "bins")
        _assert_as_jax(_torch_keep(P, r0), _jax_keep(P, r0), P, "keep")
    assert K9A.launches == before  # CPU tensors take the plain versions


@pytest.mark.parametrize("na,zero_thr,pad", CASES, ids=IDS)
def test_band_hist_is_bincount_of_jax_bins(na, zero_thr, pad):
    """The hist mode's plain version (what a CPU tensor takes, and what
    the card's kernel is held to) is the per-row bincount of the JAX
    package's bins, on every band."""
    P = _problem(na, zero_thr, pad, seed=na)
    before = K9A.launches
    for r0 in range(0, P["nxp"], BLOCK):
        want = _jax_bins(P, r0)
        if P["nx"] < P["nxp"] and (P["effp"][: P["nx"]] == 0).any():
            want = want.copy()
            want[:, P["nx"]:] = NBINS  # F6: the port masks the padding columns
        got = _torch_hist(P, r0)
        assert got.dtype == np.int32 and got.shape == (BLOCK, NBINS)
        np.testing.assert_array_equal(got, _bincount_rows(want))
    assert K9A.launches == before


def _random_bins(rng, B, nbins, kind):
    """Seeded int16 (B, 1,000) bins with the sentinel: random, every pair
    in one bin, everything in the top bin, or rows with few candidates."""
    if kind == "random":
        bins = rng.integers(0, nbins + 1, (B, 1000))
    elif kind == "one-bin":
        bins = np.where(rng.random((B, 1000)) < 0.5, rng.integers(0, nbins, (B, 1)), nbins)
    elif kind == "top":
        bins = np.where(rng.random((B, 1000)) < 0.7, nbins - 1, nbins)
    else:  # sparse: rows of 0-12 candidates, many below any cap
        bins = np.full((B, 1000), nbins)
        for r in range(B):
            k = int(rng.integers(0, 13))
            bins[r, rng.choice(1000, k, replace=False)] = rng.integers(0, nbins, k)
    return bins.astype(np.int16)


@pytest.mark.parametrize("nbins", [256, 8192])
@pytest.mark.parametrize("kind", ["random", "one-bin", "top", "sparse"])
def test_thr_from_hist_equals_bisection(nbins, kind):
    """``_band_thr_from_hist`` on the per-row histogram of seeded bins,
    bit for bit the port's and the JAX package's bisection of the bins:
    caps 1, 5, 10 and 500, rows below the cap (+inf), every candidate in
    one bin, the top bin."""
    rng = np.random.default_rng(nbins + len(kind))
    bins = _random_bins(rng, 64, nbins, kind)
    H = torch.as_tensor(np.stack([np.bincount(r[r < nbins], minlength=nbins) for r in bins])
                        .astype(np.int32))
    bin_w = np.float32(0.37)
    for cap in (1, 5, 10, 500):
        got = tloc._band_thr_from_hist(H, cap, torch.tensor(bin_w)).numpy()
        port = tloc._band_thr_from_bins(torch.as_tensor(bins), cap, torch.tensor(bin_w),
                                        nbins).numpy()
        jax = np.asarray(jloc._band_thr_from_bins(jnp.asarray(bins), cap, jnp.float32(bin_w),
                                                  nbins))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, port)
        np.testing.assert_array_equal(got, jax)
        if kind == "sparse":
            assert np.isinf(got).any() and np.isfinite(got).any() == (cap <= 12)
        if kind == "top" and cap <= 500:
            np.testing.assert_array_equal(got, np.float32(nbins) * bin_w)


@pytest.mark.parametrize("na", [5, 96])
def test_band_thresholds_dispatch_equals_jax(na):
    """``_band_thresholds``, pass 1 of the build, on CPU tensors (the
    plain bins and their bisection) equals the JAX package's thresholds
    of the same band, and equals the thresholds from the histogram."""
    P = _problem(na, False, True, seed=na + 3)
    bin_w = np.float32(1.0) / P["inv_bin"]
    for r0 in range(0, P["nxp"], BLOCK):
        args = _torch_args(P, r0)
        for cap in (1, 4, 30):
            got = tloc._band_thresholds(*args[:9], torch.tensor(bin_w), NBINS, cap, BLOCK)
            H = tloc._band_hist_sym(*args)
            np.testing.assert_array_equal(
                got.numpy(), tloc._band_thr_from_hist(H, cap, torch.tensor(bin_w)).numpy())
            jax = np.asarray(jloc._band_thr_from_bins(jnp.asarray(_jax_bins(P, r0)), cap,
                                                      jnp.float32(bin_w), NBINS))
            np.testing.assert_array_equal(got.numpy(), jax)


@pytest.mark.parametrize("na", [1, 5, 32, 33, 48, 96])
def test_packed_bits_count_shared_anchors(na):
    D = np.random.default_rng(na).random((257, na))
    S, _ = anchor_membership(D, min(5, na), "cpu")
    P = band_linf_cuda.pack_bits(S)
    assert P.dtype == torch.int32 and P.shape == (257, -(-na // 32))
    words = P.numpy().view(np.uint32)
    counts = np.bitwise_count(words[:, None, :] & words[None, :, :]).sum(axis=2)
    np.testing.assert_array_equal(counts, shared_anchor_counts(S).numpy().astype(np.int64))


def _kernel_model(P, r0, mode):
    """The kernel's arithmetic in numpy, pair by pair in float32: the max
    of |differences|, the shared count as a popcount of the packed bits,
    the admission compares, then the bin (one rounded product, truncated,
    clamped) or the threshold keep."""
    Sb, Db, eb = _band(P, r0)
    Pb = band_linf_cuda.pack_bits(torch.as_tensor(Sb)).numpy().view(np.uint32)
    Pc = band_linf_cuda.pack_bits(torch.as_tensor(P["Sp"])).numpy().view(np.uint32)
    score = np.abs(Db[:, None, :] - P["D32p"][None, :, :]).max(axis=2)
    shared = np.bitwise_count(Pb[:, None, :] & Pc[None, :, :]).sum(axis=2)
    rows = r0 + np.arange(Db.shape[0])[:, None]
    cols = np.arange(P["nxp"])[None, :]
    adm = (shared.astype(np.float32) >= np.minimum(eb[:, None], P["effp"][None, :])) & (
        cols < P["nx"])
    if mode in ("bins", "hist"):
        adm &= cols != rows
        b = np.clip(np.trunc(score * P["inv_bin"]).astype(np.int32), 0, NBINS - 1)
        bins = np.where(adm, b, NBINS).astype(np.int16)
        return bins if mode == "bins" else _bincount_rows(bins)
    adm &= cols > rows
    thr = P["thr"]
    return adm & (score <= np.maximum(thr[r0 : r0 + Db.shape[0], None], thr[None, :]))


@pytest.mark.parametrize("na", [5, 96])
def test_kernel_arithmetic_model_equals_jax(na):
    P = _problem(na, True, True, seed=na + 1)
    for r0 in range(0, P["nxp"], BLOCK):
        for mode, jax_fn in (("bins", _jax_bins), ("keep", _jax_keep)):
            _assert_as_jax(_kernel_model(P, r0, mode), jax_fn(P, r0), P, mode)
        want = _jax_bins(P, r0).copy()
        want[:, P["nx"]:] = NBINS  # F6: the port masks the padding columns
        np.testing.assert_array_equal(_kernel_model(P, r0, "hist"), _bincount_rows(want))


def test_wrapper_refuses_before_building():
    """A CPU tensor, a wrong dtype or shape, a strided bits tensor, or no
    column operands raise a clear ValueError before any build (a build
    without a CUDA compiler raises a RuntimeError instead)."""
    rng = np.random.default_rng(0)
    D = torch.as_tensor(rng.random((64, 8)).astype(np.float32))
    S, _ = anchor_membership(D.numpy(), 3, "cpu")
    rows = cols = band_linf_cuda.operands(D, S)
    e = torch.ones(64)
    inv = torch.tensor(1.0)
    before = K9A.launches
    with pytest.raises(ValueError, match="on a card"):
        band_linf_cuda.band_hist(rows, e, cols, e, 0, 64, inv, NBINS)
    with pytest.raises(ValueError, match="float32"):
        band_linf_cuda.band_hist(rows, e.double(), cols, e, 0, 64, inv, NBINS)
    with pytest.raises(ValueError, match="int16"):
        band_linf_cuda.band_hist(rows, e, cols, e, 0, 64, inv, 1 << 15)
    with pytest.raises(ValueError, match="shape"):
        band_linf_cuda.band_keep(rows, e, e[:10], cols, e, e, 0, 64)
    with pytest.raises(ValueError, match="contiguous"):
        band_linf_cuda.band_hist((rows[0], torch.zeros((64, 2), dtype=torch.int32)[:, :1]),
                                 e, cols, e, 0, 64, inv, NBINS)
    with pytest.raises(ValueError, match="columns' operands"):
        band_linf_cuda.band_keep(rows, e, e, None, e, e, 0, 64)
    assert K9A.launches == before
