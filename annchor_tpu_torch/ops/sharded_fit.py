"""The multi-device fit: ``DeviceFitState``'s stage programs over a mesh.

Port of the JAX package's ``ops/sharded_fit.py``, whose stage programs
are ``shard_map`` kernels over the 1-d ``pairs`` mesh axis.  Here a
sharded array is a list of per-shard tensors, shard c on
``mesh.devices[c]``, and every method runs the single-device function of
``ops/device_pipeline.py`` on each shard's slice; around those calls come
the padding, the shards' offsets and the collectives of ``parallel``:

* the per-pair state (lb, ub, dad, RA, ncm and the pair endpoints) is
  split on its leading axis, m_pad / s pairs per shard;
* the incidence matrix P_idx is split by rows, nx_pad / s points per
  shard; the per-point passes (thresholds, guarantee marks, graph
  assembly, the extras) run on the shard that owns the rows, against
  the gathered pair state, and their results are gathered;
* exact distances land at global pair ids through shard-local offsets:
  each id has one owner and the other shards drop it;
* the refinement selection takes each shard's local top-k and merges
  them by (probability desc, pair id asc), the single-device order;
* the sample draw and the incidence matrix are computed once, on the
  mesh's first device, from the gathered pair list (the JAX package
  computes them on every chip: "replicated compute"), and each shard is
  handed its part.

Both axes are padded to a multiple of the mesh size with sentinels
(pairs (0, 0) with RA = +inf and ncm = False; incidence rows of pad id
m_pad), which the single-device functions' ``id < m`` guards exclude
when they are given the global m.  So a sharded fit computes the same
graph as the single-device fit, bit for bit and with the same
evaluations, whenever the two track the same pair set.

Two choices differ from the JAX programs, both to keep that contract:
the column tighten updates the first ``cmax`` contenders in global id
order (the JAX program takes ``cmax`` per chip), and a gather of values
at global ids combines the owners' values by selection rather than by a
sum (a sum turns -0.0 into +0.0).
"""

from __future__ import annotations

import numpy as np
import torch

from annchor_tpu_torch import parallel, trace
from annchor_tpu_torch.ops import device_pipeline as dp
from annchor_tpu_torch.ops.bounds_update import _build_E
from annchor_tpu_torch.parallel import all_gather, broadcast, gather_to, to_device

F32_INF = float("inf")


class ShardedFit:
    """The sharded stage programs of one fit state: the mesh, the real
    and padded pair counts and the real and padded point counts."""

    def __init__(self, mesh, m_real: int, m_pad: int, nx: int, nx_pad: int):
        s = mesh.size
        assert m_pad % s == 0 and nx_pad % s == 0
        self.mesh = mesh
        self.devices = mesh.devices
        self.first = mesh.devices[0]
        self.s = s
        self.m_real = m_real
        self.m_pad = m_pad
        self.shard_m = m_pad // s
        self.nx = nx
        self.nx_pad = nx_pad
        self.shard_rows = nx_pad // s

    # -- placement --------------------------------------------------------

    def _starts(self):
        return [c * self.shard_m for c in range(self.s)]

    def put_pairs(self, arr, fill=0):
        """A length-m_real tensor (any device) padded to m_pad with
        ``fill`` and split over the shards."""
        t = torch.as_tensor(arr)
        if t.shape[0] < self.m_pad:
            pad = torch.full((self.m_pad - t.shape[0],), fill, dtype=t.dtype, device=t.device)
            t = torch.cat([t, pad])
        return [to_device(p, d) for p, d in zip(t.tensor_split(self.s), self.devices)]

    def put_rows(self, P_idx):
        """An (nx, deg) incidence matrix padded to nx_pad rows of the
        sentinel m_pad and split by rows over the shards."""
        if P_idx.shape[0] < self.nx_pad:
            pad = torch.full((self.nx_pad - P_idx.shape[0], P_idx.shape[1]), self.m_pad,
                             dtype=P_idx.dtype, device=P_idx.device)
            P_idx = torch.cat([P_idx, pad])
        return [to_device(p, d) for p, d in zip(P_idx.tensor_split(self.s), self.devices)]

    def full(self, parts):
        """The padded array (m_pad,) on the first device."""
        return gather_to(parts, self.first)

    def real(self, parts):
        """The real pairs' entries (m_real,) on the first device."""
        return self.full(parts)[: self.m_real]

    def localize(self, ids, vals=None):
        """Host pair ids (and values) split by owner: per shard, the
        local offsets (and the values) as tensors on its device."""
        ids = np.asarray(ids, dtype=np.int64)
        out = []
        for c, start in enumerate(self._starts()):
            loc = ids - start
            keep = (loc >= 0) & (loc < self.shard_m)
            dev = self.devices[c]
            loc_t = torch.as_tensor(loc[keep], device=dev)
            if vals is None:
                out.append(loc_t)
            else:
                out.append((loc_t, torch.as_tensor(np.asarray(vals)[keep], device=dev)))
        return out

    def _gathered(self, parts, fill):
        """The padded array extended by one sentinel ``fill`` (read at the
        pad id m_pad), on every shard's device: one copy per device."""
        return broadcast(dp._ext(self.full(parts), fill), self.devices)

    def _local_dev(self, ids, c):
        """Device pair ids -> shard c's local offsets; ids it does not
        own map to shard_m, one past its end (``scatter_exact`` drops them)."""
        loc = to_device(ids, self.devices[c]).long() - self._starts()[c]
        inb = (loc >= 0) & (loc < self.shard_m)
        return torch.where(inb, loc, self.shard_m), inb

    def _real_mask(self, c):
        """Shard c's real pairs (False on the padding), or None when it
        has no padding."""
        n_real = self.m_real - self._starts()[c]
        if n_real >= self.shard_m:
            return None
        return torch.arange(self.shard_m, device=self.devices[c]) < max(n_real, 0)

    # -- stage programs -----------------------------------------------------

    def sample_draw(self, dad, ncm, r, ilo, ihi, pool_n, quotas, equal_mass=False):
        """The stratified sample, drawn once on the first device from the
        gathered feature column; ``r`` is (m_pad,)."""
        return dp.sample_draw(self.full(dad), self.full(ncm), r, ilo, ihi, pool_n,
                              quotas, equal_mass=equal_mass)

    def build_pidx(self, ij_i, ij_j, lb, nx: int, max_deg: int, capped: bool):
        """The incidence matrix, built once on the first device from the
        gathered pair list (pad id m_pad) and split by rows."""
        ii, jj = self.real(ij_i), self.real(ij_j)
        lbr = self.real(lb) if capped else None
        P = dp.pidx_from_pairs(ii, jj, nx, max_deg, lb=lbr)
        if self.m_pad != self.m_real:
            P = torch.where(P >= self.m_real, self.m_pad, P)
        return self.put_rows(P)

    def features(self, D32, ij_i, ij_j, chunk: int):
        """LB/UB/dad per pair: the anchor columns on every device, each
        shard's pairs on its own."""
        Ds = broadcast(D32, self.devices)
        out = [dp.features(Ds[c], ij_i[c], ij_j[c], chunk) for c in range(self.s)]
        return tuple(list(t) for t in zip(*out))

    def regress_update(self, lb, ub, dad, RA, ncm, inner, coefs, icepts, sample_ids,
                       sample_y, is_metric: bool, init: bool):
        """Predict and clip every pair on its shard and land the sample
        exacts (host ids and values) at their owners; the padding keeps
        RA = +inf."""
        inner_s, coefs_s, icepts_s = (broadcast(t, self.devices) for t in (inner, coefs,
                                                                           icepts))
        local = self.localize(sample_ids, np.asarray(sample_y, np.float32))
        RA2, ncm2 = [], []
        for c in range(self.s):
            loc, sy = local[c]
            ra, nc = dp.regress_update(lb[c], ub[c], dad[c], RA[c], ncm[c], inner_s[c],
                                       coefs_s[c], icepts_s[c], loc, sy, is_metric, init)
            real = self._real_mask(c)
            if real is not None:
                ra = torch.where(real, ra, F32_INF)
            RA2.append(ra)
            ncm2.append(nc)
        return RA2, ncm2

    def override_rows(self, RA, local):
        """RA at ``localize``d (ids, values), in place."""
        for c, (loc, vals) in enumerate(local):
            RA[c][loc] = vals
        return RA

    def scatter_exact_host(self, RA, ncm, ids, vals):
        """Land exact distances at host pair ids (in place)."""
        for c, (loc, v) in enumerate(self.localize(ids, np.asarray(vals, np.float32))):
            dp.scatter_exact(RA[c], ncm[c], loc, v)
        return RA, ncm

    def scatter_exact(self, RA, ncm, ids, vals):
        """Land exact distances at device pair ids: each shard scatters
        the ids it owns into its slice extended by one drop slot."""
        RA2, ncm2 = [], []
        for c in range(self.s):
            loc, _ = self._local_dev(ids, c)
            ra = dp._ext(RA[c], 0.0)
            nc = dp._ext(ncm[c], False)
            dp.scatter_exact(ra, nc, loc, to_device(vals, self.devices[c]))
            RA2.append(ra[: self.shard_m])
            ncm2.append(nc[: self.shard_m])
        return RA2, ncm2

    def gather_pairs(self, arrs, ids):
        """Values of sharded per-pair arrays at global pair ids (a tensor),
        on the ids' device: each value comes from its owner shard."""
        out = [None] * len(arrs)
        for c in range(self.s):
            loc, inb = self._local_dev(ids, c)
            loc = torch.where(inb, loc, 0)
            inb = to_device(inb, ids.device)
            for k, a in enumerate(arrs):
                v = to_device(a[c][loc], ids.device)
                out[k] = v if out[k] is None else torch.where(inb, v, out[k])
        return tuple(out)

    def select(self, RA, ncm, ij_i, ij_j, dad, P_idx, inner, cdf_grid, cdf_lo, cdf_inv,
               cdf_hi, nn: int, n_ref: int, guarantee: bool, nmin: int):
        """Sharded twin of ``device_pipeline.select``: thresholds and
        guarantee marks on the shards that own the incidence rows, against
        the gathered RA; thresholds gathered, marks combined; probabilities
        on the shards that own the pairs; each shard's top n_ref merged by
        (probability desc, pair id asc), ``select``'s tie-break.  Returns
        (chosen, thresholds (nx,), ij_i, ij_j at the chosen ids) on the
        first device."""
        devs = self.devices
        m = self.m_real
        kk = min(nn, int(P_idx[0].shape[1]) - 1)
        RA_p = self._gathered(RA, F32_INF)
        ncm_p = self._gathered(ncm, False)
        th_parts, mark_parts = [], []
        for c in range(self.s):
            th, mk = dp.select_point_pass(RA_p[c], ncm_p[c], P_idx[c], m, kk, guarantee, nmin)
            th_parts.append(th)
            if guarantee:
                mark_parts.append(mk.to(torch.uint8))
        del RA_p, ncm_p
        thresh = all_gather(th_parts, devs)
        # a pair is marked if any shard marked it
        marks = parallel.pmax(mark_parts, devs) if guarantee else None
        small = [broadcast(t, devs) for t in (inner, cdf_grid, cdf_lo, cdf_inv, cdf_hi)]
        k_loc = min(n_ref, self.shard_m)
        vals, gids = [], []
        for c, start in enumerate(self._starts()):
            RAg = RA[c]
            if guarantee:
                mine = marks[c][start : start + self.shard_m] > 0
                RAg = torch.where(mine, torch.full_like(RAg, -1.0), RAg)
            prob = dp.select_pair_probs(thresh[c], RAg, ncm[c], ij_i[c], ij_j[c], dad[c],
                                        *(t[c] for t in small))
            top = torch.sort(prob, descending=True, stable=True)
            vals.append(top.values[:k_loc])
            gids.append(top.indices[:k_loc] + start)
        # shard order is id order, so a stable sort of the concatenation
        # breaks ties by the lower pair id
        v_all = gather_to(vals, self.first)
        g_all = gather_to(gids, self.first)
        chosen = g_all[dp.top_ids(v_all, n_ref)]
        sel_i, sel_j = self.gather_pairs((ij_i, ij_j), chosen)
        return chosen, thresh[0][: self.nx], sel_i, sel_j

    def _pair_sums(self, ij_i, ij_j):
        """The gathered pair sums with their sentinel, on every device."""
        return self._gathered([ij_i[c].long() + ij_j[c].long() for c in range(self.s)], 0)

    def _rows(self, fn, *per_shard):
        """fn(row0, *args of shard c) on every shard c, whose incidence
        rows start at point row0; results gathered on the first device and
        cut to nx rows."""
        outs = [fn(c * self.shard_rows, *(a[c] for a in per_shard)) for c in range(self.s)]
        if isinstance(outs[0], tuple):
            return tuple(gather_to(list(o), self.first)[: self.nx] for o in zip(*outs))
        return gather_to(outs, self.first)[: self.nx]

    def knn(self, RA, ncm, P_idx, ij_i, ij_j, nn: int):
        """Sharded twin of ``device_pipeline.knn``: each shard assembles
        the rows it owns."""
        RA_p = self._gathered(RA, F32_INF)
        ncm_p = self._gathered(ncm, True)
        ps = self._pair_sums(ij_i, ij_j)
        return self._rows(
            lambda row0, ra, nc, p, P: dp.knn_rows(ra, nc, p, P, nn, self.m_real, row0),
            RA_p, ncm_p, ps, P_idx)

    def enemy_refine(self, RA, ncm, P_idx, ij_i, ij_j, y, k: int):
        """Sharded twin of ``device_pipeline.enemy_refine_select``."""
        kk = min(int(k), int(P_idx[0].shape[1]))
        RA_p = self._gathered(RA, F32_INF)
        ncm_p = self._gathered(ncm, False)
        ps = self._pair_sums(ij_i, ij_j)
        ys = broadcast(y, self.devices)
        return self._rows(
            lambda row0, ra, nc, p, P, yc: dp.enemy_refine_rows(
                ra, nc, p, P, yc, kk, self.m_real, row0),
            RA_p, ncm_p, ps, P_idx, ys)

    def enemy_knn(self, RA, ncm, P_idx, ij_i, ij_j, y, nn: int):
        """Sharded twin of ``device_pipeline.enemy_knn``."""
        RA_p = self._gathered(RA, F32_INF)
        ncm_p = self._gathered(ncm, True)
        ps = self._pair_sums(ij_i, ij_j)
        ys = broadcast(y, self.devices)
        return self._rows(
            lambda row0, ra, nc, p, P, yc: dp.enemy_knn_rows(
                ra, nc, p, P, yc, nn, self.m_real, row0),
            RA_p, ncm_p, ps, P_idx, ys)

    def cover_incidence(self, RA, ncm, ub, P_idx, ij_i, ij_j, slot, radii, S: int):
        """Sharded twin of ``device_pipeline.cover_incidence``."""
        dists = [torch.where(ncm[c], ub[c], RA[c]) for c in range(self.s)]
        d_p = self._gathered(dists, F32_INF)
        ps = self._pair_sums(ij_i, ij_j)
        slots = broadcast(slot, self.devices)
        radii_s = broadcast(radii, self.devices)
        return self._rows(
            lambda row0, d, p, P, sl, rd: dp.cover_incidence_rows(
                d, p, P, sl, rd, S, self.m_real, row0),
            d_p, ps, P_idx, slots, radii_s)

    def _computed(self, ncm, c):
        """Shard c's computed real pairs."""
        real = self._real_mask(c)
        return ~ncm[c] if real is None else ~ncm[c] & real

    def tighten_full(self, ij_i, ij_j, RA, ncm, lb, ub, nx: int, block: int = 16):
        """Sharded tropical tighten: every shard scatters its computed
        pairs into its device's (nx, nx) matrix (distinct pairs own
        distinct entries, so the shards of one device share it, and the
        matrices of several devices sum exactly); the product's columns
        split evenly over the shards, whose partial bounds combine by
        max/min; each shard re-bounds its own pairs."""
        EV = {}
        for c, d in enumerate(self.devices):
            IJ = torch.stack([ij_i[c].long(), ij_j[c].long()], dim=1)
            E, V = _build_E(IJ, RA[c], self._computed(ncm, c), nx, out=EV.get(d))
            EV[d] = (E, V)
        Es = parallel.psum([EV[d][0] for d in EV])
        Vs = parallel.psum([EV[d][1].to(torch.uint8) for d in EV])
        EV = {d: (Es[k], Vs[k] > 0) for k, d in enumerate(EV)}
        nblk = (nx + block - 1) // block
        per = -(-nblk // self.s) * block
        lbs, ubs = [], []
        for c, d in enumerate(self.devices):
            E, V = EV[d]
            Einf = torch.where(V, E, torch.full_like(E, F32_INF))
            y0, y1 = min(c * per, nx), min((c + 1) * per, nx)
            with parallel.shard_scope(c):
                lbM, ubM = dp.tropical_product(E, V, Einf, y0, y1, block)
            lbs.append(lbM)
            ubs.append(ubM)
        lbM = parallel.pmax(lbs, self.devices)
        ubM = parallel.pmin(ubs, self.devices)
        out = [dp.rebound_pairs(ij_i[c], ij_j[c], ncm[c], lb[c], ub[c], lbM[c], ubM[c])
               for c in range(self.s)]
        return [o[0] for o in out], [o[1] for o in out]

    def tighten_cols(self, ij_i, ij_j, RA, ncm, lb, ub, thresh, ncol: int, cmax: int,
                     chunk: int = 65536, col_chunk: int | None = None):
        """Sharded twin of ``device_pipeline.tighten_cols``: computed
        degrees summed over the shards, the columns picked once, the
        column panel scattered by every shard into its device's panel
        (min-combined across devices), and each shard's contenders
        tightened on its own device: the first ``cmax`` contenders in
        global id order, as on one device."""
        nx = self.nx
        devs = self.devices
        degs = []
        for c in range(self.s):
            w = self._computed(ncm, c).long()
            deg = torch.zeros(nx, dtype=torch.int64, device=devs[c])
            deg.index_add_(0, ij_i[c].long(), w).index_add_(0, ij_j[c].long(), w)
            degs.append(deg)
        col_chunk, ncol_pad = dp.column_chunks(ncol, nx, col_chunk)
        cols = broadcast(dp.tighten_columns(parallel.psum(degs, [self.first])[0], ncol,
                                            ncol_pad), devs)
        th = broadcast(thresh, devs)
        ids, left = [], int(cmax)
        for c in range(self.s):
            # the padding's ncm is False: it never contends
            found = dp.tighten_contenders(ij_i[c], ij_j[c], ncm[c], lb[c], th[c])
            ids.append(found[: max(left, 0)])
            left -= int(found.shape[0])
        trace.count(pairs=sum(int(x.shape[0]) for x in ids))
        lb = [t.clone() for t in lb]
        ub = [t.clone() for t in ub]
        for c0 in range(0, ncol_pad, col_chunk):
            n_real = min(col_chunk, ncol - c0)
            panels = {}
            for c, d in enumerate(devs):
                pending = ~self._computed(ncm, c)
                panels[d] = dp.column_panel(ij_i[c], ij_j[c], RA[c], pending,
                                            cols[c][c0 : c0 + col_chunk], n_real, nx,
                                            out=panels.get(d))
            merged = parallel.pmin(list(panels.values()))
            panels = dict(zip(panels, merged))
            for c, d in enumerate(devs):
                dp.column_pass(panels[d], ij_i[c], ij_j[c], lb[c], ub[c], ids[c], chunk)
            del panels, merged
        return lb, ub

    def clip_ra(self, RA, ncm, lb, ub):
        return [dp.clip_ra(RA[c], ncm[c], lb[c], ub[c]) for c in range(self.s)]
