"""Smoke run of the PyTorch/CUDA port (annchor_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once, as a user would: the strings-1600
Levenshtein fit, ``Annchor(X, "levenshtein", n_neighbors=25,
p_work=0.12, random_seed=42)`` on the synthetic 1600-string set, scored
against the exact graph from the port's own ``BruteForce``.  Phases, each
of which exits non-zero when it fails:

1. device: the card's name and power limit, and the build of every
   kernel from the sources in this checkout (K1, K10, K4, K9a, K8, K12
   and the host EMD solver, one compiler process each, started together),
   with ptxas's registers and spills for each instantiation;
2. kernel check: the CUDA edit-distance kernel (K1), in each launch mode
   (auto, thread, group), against its plain PyTorch version, bit for
   bit, on 82,180 pairs (empty strings, word boundaries, alphabets
   2/4/26, the strings-1600 shapes, patterns of 40-48 and 63-64 words
   and of more than 64, and strings-1600 with twelve long strings whose
   pairs run down the overflow lists), then one K1 call in each mode
   under ``torch.cuda.set_sync_debug_mode("error")`` on strings-1600
   and on it with one 2,100-character string, then against the
   pure-Python DP on 64 sampled strings-1600 pairs, then a small fit on
   the card against the same fit on the CPU; K10, the kernel over more
   than 192 symbols, in each launch mode (auto, thread, group) against
   its plain version (the row DP) bit for bit, on 7,000 random pairs and
   every self pair of each of four sets: 193, 256 and 1,000 symbols
   (empty strings, lengths 1-600 and one of 2,100) and 20,000 CJK and
   astral code points (lengths 0-600, one string of 5,000 characters and
   one of 2,600 for long mode), both argument orders, every call under
   ``set_sync_debug_mode("error")``, thread, group and long mode each
   launched, and 64 pairs against the pure-Python DP; then the strings'
   encoding built on the card (``MyersEncoding.on_device``) against the
   host build, bit for bit, on strings-1600, an astral set and 193
   symbols, with both builds' times; then the hybrid's
   certify dispatch (the Sinkhorn
   scout's values of 40,000 digit pairs queued on the card) under
   ``set_sync_debug_mode("error")``, its values against the same engine
   on the CPU; K4, the dense tropical tighten, against its plain version
   bit for bit at nx 1, 17, 1,000, 4,096, on rows with no computed
   entry, on an E with every entry present and on strings-1600's E at
   both tightens of its fit (every column, a sub-range, and two
   sub-ranges that combine to the whole); K9a, the band build's linf
   score, in both modes (pass 1's per-row histogram, pass 2's keep mask)
   bit for bit at na 5, 32, 48, 96 and 160 over padded bands, zero
   thresholds, the diagonal, +inf thresholds and a ragged chunk, and the
   thresholds from each histogram bit for bit the plain bins' bisection;
   every K4 and K9a call under ``set_sync_debug_mode("error")``; K8a,
   the Sinkhorn scout's loop, against its plain version to rtol 2e-6 and
   bit for bit against its torch model, on the digits (with all-zero
   rows, one-bin rows and self pairs) at n_iter 1, 2 and 300 on 1, 256,
   1,797 (an anchor column) and 8,192 pairs, the column and the chunk
   also streamed, on random costs at 5 (8,192 pairs, streamed in every
   tile), 100, 144 (the most bins resident), 145 and 300 (streamed), 784,
   2,100 and 7,200 bins, and through the engine's dispatch of 9,000
   pairs (a ragged last chunk); K8b, the log-domain loop, against its
   plain version to rtol 1e-5 and bit for bit against its torch model on
   the digits at n_iter 1, 2 and 200 on 1, 256 and 4,096 pairs and on
   random costs at 5 and 100 bins (resident) and 300, 784 and 14,401 bins
   (streamed); every K8 call under ``set_sync_debug_mode("error")``,
   with exactly its plan's launches;
3. exact graph: ``BruteForce`` on strings-1600 (1,279,200 pairs);
4. fit: one warm-up fit, then one timed fit with the stage table, which
   must launch K1 and stay within the evaluation budget; then the same
   fit drawing its samples from the JAX package's stream
   (``jax_threefry_uniforms``), which must spend exactly the JAX
   package's evals on this set and score no more errors against the
   exact graph than the JAX package does, each launching K4; then one fit
   under ``torch.profiler`` for K1's and K4's share of the device time;
5. timing: K1 at the main path's batch shapes (strings-1600's anchor
   column, sample batch, refine batch and BruteForce, a 100,000-pair
   column of the 100k corpus, and the anchor column and BruteForce of
   strings-1600 with one 2,100-character string): the time through the
   wrapper, the
   kernel-only time of the bare launch in the mode the wrapper picks and
   in each forced mode, the word steps, the bound and its share, the
   plain version's time and the one-thread-per-pair kernel's it
   replaced; then the thread/group crossover
   sweep behind the wrapper's dispatch rule; then K4 at nx 1,600
   (strings-1600's E) and 4,096 and K9a on a (4096, 2048, 96) chunk of
   random profiles in both modes: ms, bound and share (the bound counts
   the steps the data needs: K4's present entries, K9a's admitted pairs;
   the dense bound beside it), the plain version's ms, and for K9a the
   rms score's and ``torch.cdist(p=inf)``'s ms; then K8a on an 8,192-pair
   digits chunk and a 1,797-pair anchor column at n_iter 300 (resident,
   and streamed forced) and at large n (300 and 784 bins on 8,192 pairs,
   2,100 and 7,200 on 64) and K8b on 4,096 pairs at n_iter 200 and at
   large n (300 and 784 bins on 8,192 pairs, 14,401 on 2), beside
   their bounds (the FP64 peak; expf, with the FP32 pipe's beside it),
   plain versions and, for K8a, the plain version's float64 ``torch.mm``
   alone; then K12, the exact EMD, on a digits-5620 certify's 120,914
   pairs and a digits-1797 query's 8,980, bit-equal to the host solver,
   beside its FP64 pricing bound and the host solver's time;
6. vector metrics: the euclidean, sqeuclidean and cosine engine on the
   card against a float64 oracle, the blobs contract (0 errors) and a
   euclidean fit on 4,096 x 64 blobs, held to the JAX package's evals and
   errors, which must launch K4;
7. a Python-callable metric: an L1 closure evaluated on host threads
   with the fit's state on the card, held to the JAX package's figures;
8. the host pipeline (a custom sampler): the strings-1600 fit, which
   must launch K1 and spend exactly the JAX package's evals; (b) the
   same on the 5,000 strings of phase 9(a), above 4,096 points (the
   blocked host pair build), held to the JAX package's evals;
9. the scale path (nx > 4096: budgeted band build, sparse fit state,
   column tighten, graph-expansion refinement), K1 first held against
   its plain version on 20,000 pairs of each corpus: (a) a 5,000-string
   fit with the JAX sample stream, held to the JAX package's evals and
   errors; (b) the default-constructor fit of 100,000 evolve strings of
   ~400 characters, which must run in sparse mode, launch K1 and K9a
   in both modes (its band build), stay
   within int(p_work * N) evals and reach distance recall >= 0.99 over
   500 exact rows from ``exact_rows`` (K1) before the fit; its
   refinement screens on the card (each round's ``screen_dev_s`` and
   host split printed), and one more round on the fitted index holds the
   device screen's slates to the host screen's, bit for bit; the
   build's first and last band, 4,096 x 102,400 at na 96, are held
   through K9a's dispatch bit for bit to its plain versions in both
   modes with no host sync, and timed (the kernels line's K9a figures);
   (c) the
   5,000-string fit under ``ANNCHOR_TPU_BUILD_SCORE=rms`` within its
   budget and the JAX test's family bound of (a)'s errors, and one
   (4096, 2048, 96) band chunk's score timed under linf and rms;
10. serve, the post-fit surface, held to the JAX package's figures
   pinned at the top of the script: (a) ``query`` of 1,000 mutated
   strings against phase 4's JAX-stream fit, scored over their exact
   rows by K1; (b) that index saved as v1 and loaded into a new object,
   whose graph and query must be bit-equal; (c) nearest enemies,
   selective subset, alpha-RSS and ``legacy_query`` on 1,000 blobs;
   (d) nearest enemies and the selective subset on the 5,000-string
   fit's sparse device state, which must survive them; (e) the 100k
   index saved as v2, loaded with ``rebuild_pairs=True`` (the same
   graph and pair list; its band build launches K9a in both modes), queried with 500 mutated strings (distance
   recall >= 0.99 over their exact rows by K1) and refined with free
   merges from the stored exact values.  Each query is timed, with the
   share of its wall spent encoding strings, then run again without the
   engine's encoding hold, which must give the same answer.  Exact query
   rows come from ``exact_query_rows`` (K1);
11. exact oracles and the slow metrics: (a) ``exact_knn(X, "levenshtein",
   k=25)`` over strings-1600, which must launch K1 and equal phase 3's
   ``BruteForce`` graph (distances bit-equal, indices equal wherever the
   25th distance is not tied); (b) the digits-1797 scout/certify hybrid,
   ``Annchor(X, "wasserstein", func_kwargs={"cost_matrix":
   grid_cost_matrix(), "scout": "sinkhorn"}, n_anchors=25, n_neighbors=25,
   n_samples=5000, p_work=0.16, random_seed=42)`` (BENCHMARKS.md's
   protocol), scored against ``exact_knn(X, "wasserstein", k=25,
   device="cpu")`` on the host's EMD solver (the same graph by K12,
   ``device="cuda"``, must be bit-equal to it): < 10 errors, every
   reported distance the exact EMD to 1e-9; its wall split into the
   Sinkhorn scout's device time (under ``torch.profiler``: K8a's device
   ms and launches) and the exact EMD seconds; K8a launched, and K12
   once for each exact batch of the fit; (c) ``wasserstein_sinkhorn`` on
   the first 300 digits: neighbour-set recall >= 0.9 against the exact
   graph (the host's solver), K8b
   launched, and the same fit under ``torch.profiler`` in a fresh process
   (K8b's device ms; every K8b launch must be recorded);
   (d) graph-sp on the 796-vertex component of ``make_graph()``
   with the JAX sample stream, which must spend the JAX package's evals
   and score no more errors against the exact graph;
12. the admit-everything build and the row DP: (a) the digits-5620
   scout/certify hybrid (``load_digits_large()``, BENCHMARKS.md's
   ``digits_large`` protocol, ``n_anchors=30, n_neighbors=25,
   p_work=0.1``, the JAX sample stream), non-metric above 4,096 points so
   built by ``candidate_pairs_device``, held to the JAX package's pinned
   calls and errors against the stored exact graph, every reported
   distance the exact EMD to 1e-9, K8a launched; timed with the stage
   table, then under ``torch.profiler``; (b) the same fit with ``max_resident_pairs`` at
   half its admitted total, which must switch to the budgeted build; (c)
   strings-1600 over 256 code points (phase 4's arguments, the JAX sample
   stream), every evaluation on K10: the JAX package's evals, no more
   errors than its against a BruteForce on K10, K10 launched in thread
   and group mode, K4 launched; the same fit under ``torch.profiler`` (K10's device
   ms); the sparse Peq table's build seconds over 256 and 20,000
   symbols; then K10 at the refine batch, an anchor column and
   BruteForce's pairs: the time through its wrapper, the word steps and
   search probes, the bound and its share, the row DP's cell bound, the
   time before the redesign (and at the refine batch the plain version,
   bit for bit); then the thread/group crossover sweep.

13. the multi-device fit, its pair state sharded over a mesh of four
   shards (``ANNCHOR_TPU_MESH_DEVICES=4``: every visible card, repeated
   round-robin, so on one card all four shards are that card): (c) the
   mesh's devices and distinct cards, and K1 through the sharded engine
   against its plain version on 20,000 strings-1600 pairs; (a) phase 4's
   JAX-stream strings-1600 fit, whose graph must equal phase 4's bit for
   bit with its 157,793 evals; (b) phase 9's 100k fit at the pair cap
   phase 9 derived (``ANNCHOR_TPU_PAIR_CAP``), whose pair list, m, evals
   and graph must equal phase 9's, with each shard's residency, the
   stage table, the wall and the peak memory beside phase 9's; (d) the
   rms build score on the mesh, which must raise.  Each fit must launch
   K1 on every shard, (a) K4 and (b) K9a too.

K1's launches, in all and per mode, are counted in the fits of phases
4, 8 and 9, in the calls of phase 10 (a), (b), (d) and (e) and in phase
11(a)'s ``exact_knn``, K10's, in all and per mode, in phase 12(c)'s fit, each with the counts
set to 0 just before it; K1's launches per shard in phase 13's fits
(a) and (b), with the counts set to 0 just before each.  K4's launches
are counted the same way in phase 4's two fits (the kernels line's
"launches"), phase 6's 4,096 x 64 fit, phase 12(c)'s fit and per shard
in phase 13(a); K9a's by mode in phase 9(b)'s 100k fit (its
"launches"), phase 9(a)'s, phase 10(e)'s ``load(rebuild_pairs=True)``
and per shard in phase 13(b); K8a's in each fit of phase 11(b) and
12(a) (its "launches": the two timed fits) and K8b's in phase 11(c)'s
fit.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

N_NEIGHBORS = 25
P_WORK = 0.12
# 256 code points (U+0100-U+01FF): strings-1600 over more than 192 symbols,
# the row-DP kernel's domain (phase 12(c))
ALPHA256 = "".join(map(chr, range(0x100, 0x200)))
# The JAX package's fit of this synthetic set (annchor_tpu.Annchor with
# the same arguments, on the CPU): its evals and its errors against the
# exact graph.  The set's star-shaped clusters put every intra-cluster
# distance in one narrow band, so it is far harder than the reference's
# bundled strings (158,716 evals, 0 errors there); the sampler's bins
# run short, hence fewer than 2 x 5,000 sample evals.
REFERENCE_EVALS = 157_793
REFERENCE_ERRORS = 1_297
REFINE_BATCH = 58_707  # the first refinement batch of that fit

# Pinned figures of the JAX package (annchor_tpu on the CPU, same data,
# same arguments, its own sample stream; the port's fits below draw that
# stream through ``jax_threefry_uniforms`` or, on the host pipeline, the
# same numpy generator).
#
# Euclidean on 4,096 x 64 blobs (10 centers, seed 42), n_neighbors=15,
# p_work=0.05: 424,540 evals, 18,117 errors against BruteForce.  The
# card sums each 64-wide row in another order than XLA on the CPU, so
# features can move by a few float32 ulps and with them an estimate's
# rank; the errors are held to <= the JAX count, not to equality.
BLOBS4096_EVALS = 424_540
BLOBS4096_ERRORS = 18_117
# The L1 closure on the reference blobs (1000 x 2, 10 centers, seed 42),
# n_anchors=10, p_work=0.05: 34,948 evals, 0 errors against a
# BruteForce with the same closure.
CLOSURE_EVALS = 34_948
CLOSURE_ERRORS = 0
# strings-1600 on the host pipeline (a do-nothing SimpleStratifiedSampler
# subclass), n_neighbors=25, p_work=0.12: 157,792 evals, 1,356 errors
# against the exact graph.  That CPU run hit the host tighten's 10 s
# wall-clock bailout (it tightened 400,000 of 1,185,409 pending pairs,
# ROADMAP H5), so a faster run tightens more: evals must be equal and the
# errors may only be fewer.
HOST_EVALS = 157_792
HOST_ERRORS = 1_356
# Phase 9(a): make_strings(n=5000, n_clusters=16, length=200,
# mutation_rate=0.01, seed=42, evolve=True), Annchor(X, "levenshtein",
# n_neighbors=15, p_work=0.05, random_seed=42) on the scale path (na 48,
# loc_thresh 3, niters 4, refine_frac 0.05): 624,875 evals, 15,067 of
# them in the three refinement rounds; 240 errors against BruteForce.
SCALE5K_EVALS = 624_875
SCALE5K_ERRORS = 240
# Phase 9(b): 100,000 strings, the default constructor at p_work 0.01;
# distance recall over 500 exact rows (the JAX package measured 1.0000
# on this corpus family).
# phase 13's mesh: shards over the visible cards, repeated on one card
MESH_SHARDS = 4
SCALE100K_N = 100_000
SCALE100K_P_WORK = 0.01
SCALE100K_ROWS = 500
SCALE100K_MIN_RECALL = 0.99
# Phase 10 (serve), from ``tools/pin_serve_figures.py`` (annchor_tpu on
# the CPU, same data and arguments).  (a) The JAX package's own
# strings-1600 fit (phase 4's arguments) queried with
# mutate_strings(X[:1000], 0.05, 7) at nn=15, p_work=0.2: distance recall
# 1.000000 over the exact query rows, every query's source first.
SERVE_QUERY_RECALL = 1.0
SERVE_QUERY_SLACK = 0.005
# (c) make_blobs(1000, 2, 5, 1), euclidean, n_anchors=12, n_neighbors=15,
# p_work=0.4, random_seed=42: 204,880 fit evals, 20,952 more in
# get_nearest_enemies(y, nn=3) (first-enemy accuracy 0.98), a selective
# subset of 85 points, an alpha_rss subset of 81.
SERVE_BLOBS_EVALS = 204_880
SERVE_BLOBS_ENEMY_EVALS = 20_952
SERVE_BLOBS_SUBSET = 85
# (d) phase 9(a)'s strings-5000 fit with make_strings' cluster ids as
# labels: 227,812 evals in get_nearest_enemies(y, nn=3); the first enemy
# distance equals the exact nearest enemy for 0.7120 of 500 rows
# (default_rng(3)), 0.4460 edits over it on average; a selective subset
# of 155.  Every enemy of a row sits in one narrow band of distances
# (the clusters are mutation trees of unrelated seeds), so the 50
# closest predicted enemies a row evaluates often miss the nearest by an
# edit or two.
SERVE_5K_ENEMY_EVALS = 227_812
SERVE_5K_ENEMY_EXACT = 0.7120
SERVE_5K_SUBSET = 155
# PR 5's hand-written exact oracles (one K1 call per row), seconds by this
# script on the same card type and limit: phase 9's 500 rows of the 100k
# corpus and phase 10(e)'s 500 query rows against it, two runs each
ORACLE_BEFORE_S = {"100k rows": (4.149, 4.149), "100k query rows": (3.555, 4.389)}
# Phase 11, from ``tools/pin_hybrid_figures.py`` (annchor_tpu on the CPU,
# same data and arguments).  (b) The digits-1797 hybrid: 39,054 exact
# calls, 406,986 scout calls, 0 errors against BruteForce.  The card's
# Sinkhorn values differ from XLA:CPU's by float32 ulps, so the calls may
# differ a little; the contract is < 10 errors (the reference scores 0).
DIGITS_EVALS = 39_054
DIGITS_SCOUT_EVALS = 406_986
DIGITS_ERRORS = 0
DIGITS_MAX_ERRORS = 10
# (c) the reference test's recall floor (tests/test_hybrid.py:110-140)
SINKHORN_MIN_RECALL = 0.9
# (d) graph-sp on the 796-vertex component, n_anchors=20, n_neighbors=15,
# p_work=0.15, random_seed=42: 52,672 evals, 39 errors against BruteForce
GRAPH_EVALS = 52_672
GRAPH_ERRORS = 39
# Phases 8(b) and 9(c), from ``tools/pin_lev_figures.py --stage strings5k``
# (annchor_tpu on the CPU, phase 9(a)'s data and arguments, errors against
# the exact 15-NN graph): (8b) with a do-nothing sampler subclass, the
# host pipeline above 4,096 points, 624,875 evals over 1,415,065
# candidate pairs, 9 errors; its host tighten stops after 10 s of wall
# clock (ROADMAP H5), so a faster run may find another graph: evals must
# be equal, errors are held to a coarse bound.  (9c) under
# ANNCHOR_TPU_BUILD_SCORE=rms: 624,875 evals over 539,622 tracked pairs,
# 139 errors; the card's rms panel differs from XLA's in the last bits
# (``ops/locality._band_score``), so its errors are held to the JAX test's
# family bound of the linf fit (tests/test_scale_path.py:836).
HOST5K_EVALS = 624_875
HOST5K_ERRORS = 9
RMS5K_EVALS = 624_875
RMS5K_ERRORS = 139
# Phase 12(c), from ``tools/pin_lev_figures.py --stage alpha256``:
# strings-1600 over 256 code points with phase 4's arguments, every
# evaluation on the row DP: 158,716 evals, 1,969 errors against the exact
# 25-NN graph (the star clusters' narrow band of distances, as on ACGT).
ALPHA256_EVALS = 158_716
ALPHA256_ERRORS = 1_969
# Phase 12(a), from ``tools/pin_hybrid_figures.py --stage digits-large``:
# the digits-5620 hybrid against the stored exact graph, run with the
# reference's own loc_thresh 1 and niters 2 (the knobs its digits_large
# protocol was defined under, reference doc/user_guide.rst:262-270): the
# constructor's defaults above 4,096 points (loc_thresh 3, niters 4)
# admit 2,434,931 pairs and leave the JAX package at 62 errors (126,859
# exact, 2,208,753 scout calls), over the contract's 10.
DIGITS5620_KNOBS = {"loc_thresh": 1, "niters": 2}
DIGITS5620 = {"evals": 120_902, "scout_evals": 2_171_905, "m": 10_479_208, "errors": 1}

# K1's bound: a word step (one 32-bit pattern word advanced by one text
# character) is at least 10 INT32 instructions (the add with carry in and
# out is one IADD3.X; csrc/levenshtein_myers.cu); the H100 SXM issues 132
# SMs x 64 INT32 lanes x 1.98 GHz of them a second, and moves 3.35e12
# bytes/s.
K1_OPS_PER_STEP = 10
# K10's bound: its word steps at K1's 10 INT32 instructions, plus 2 (a
# compare and a select) for each probe of its search of the pattern's
# symbols (csrc/levenshtein_rowdp.cu), at the same rate
K10_OPS_PER_PROBE = 2
# the bound of the row DP that K10 replaced, printed for the record: a
# cell is about 5 INT32 operations (two adds, the character compare folded
# into the diagonal's cost, two mins)
K10_OPS_PER_CELL = 5
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# K4's and K9a's bound: their FMNMX (float min/max), 64 lanes a clock per
# SM on the H100 SXM, 132 x 64 x 1.98e9 a second, counted over the steps
# the inputs need: K4 2 for each (i <= j, y) with both E[i, y] and
# E[j, y] present (csrc/tropical_tighten.cu), K9a 1 for each anchor of a
# pair its pass admits (csrc/band_linf.cu); beside it, the bound of the
# steps the kernel's tiling does (K4: every (i <= j, y); K9a: every pair
# its masks leave, before the shared-anchor filter)
FMNMX_PER_S = 132 * 64 * 1.98e9
# K8's bounds (csrc/sinkhorn.cu): K8a's (2 n_iter + 2) n^2 FP64 FMA a pair
# at the card's FP64 peak, its tensor cores' 128 FMA a clock per SM (67
# TFLOP/s), which K8a's mma.sync runs on; K8b's (2 n_iter + 1) n^2 expf a
# pair, one MUFU.EX2 each at 16 a clock per SM; H100 SXM, 132 SMs at 1.98
# GHz
FP64_FMA_PER_S = 132 * 128 * 1.98e9
# K12's bound (csrc/emd_simplex.cu): its pricing, one DADD and one DSETP
# for each reduced cost of each pass, on the FP64 pipe outside the tensor
# cores, 64 lanes a clock per SM (H100 SXM, 132 SMs at 1.98 GHz)
FP64_OPS_PER_S = 132 * 64 * 1.98e9
# K12's batches: the pairs of a traced digits-5620 fit's certify and a
# digits-1797 query call's
K12_BATCHES = {"K12 certify 5620": 120_914, "K12 query 1797": 8_980}
EXPF_PER_S = 132 * 16 * 1.98e9
# beside K8b's expf bound, its FP32 pipe's: K8B_FP32_PER_ELEM FP32-pipe
# instructions (FADD, FFMA, FMUL) for each element of a half step's two
# sweeps over k (csrc/sinkhorn.cu: the max sweep's add; the sum sweep's two
# adds, the accurate expf's five FFMA/FADD and its FMUL, the running add;
# the count of the resident kernel's SASS, cuobjdump -sass) at 128 lanes a
# clock per SM
K8B_FP32_PER_ELEM = 10
FP32_PER_S = 132 * 128 * 1.98e9
# K8b's large-n shapes timed in phase 5 (bins, pairs, n_iter): 300 and 784
# bins (28 x 28 images) in chunks of 8,192, 2 pairs at 14,401 (120 x 120)
K8B_LARGE = ((300, 8192, 20), (784, 8192, 20), (14_401, 2, 1))
# K8a's large-n shapes timed in phase 5 (bins, pairs, n_iter): random
# histograms of 300 and 784 bins (28 x 28 images) in chunks of 8,192, and
# 64 pairs at 2,100 and 7,200 bins
K8A_LARGE = ((300, 8192, 20), (784, 8192, 20), (2100, 64, 2), (7200, 64, 2))
# K8 against its plain versions: K8a rounds each float64 sum once to
# float32 as the plain version does, but sums in another order than
# cuBLAS (tests/test_torch_sinkhorn.py).  K8b sums its float32 terms in
# another order than PyTorch's reductions, and its result exp(-C/eps + f/eps
# + g/eps) C takes the potentials' rounding whole: f/eps and g/eps reach
# max(C)/eps = 50, whose float32 ulp is 3.8e-6 of exp's argument
K8A_RTOL = 2e-6
K8B_RTOL = 1e-5
# K1 through the wrapper before its redesign (one thread per pair, pairs
# sorted by word count on the card), measured by this script's phase 5 on
# the same card type and limit; the 100k column is get_anchors' 0.257 s
# stage wall over its 96 columns; the skewed shapes are the parent
# commit's wrapper timed by tools/time_k1_wrapper.py on the same card
BEFORE_MS = {
    "anchor column": 2.7,
    "sample batch": 2.17,
    "refine batch": 2.634,
    "BruteForce": 19.7,
    "100k column": 0.257 / 96 * 1e3,
    # the mean of two parent runs (4.3786 / 4.3877 and 27.2854 / 27.0232)
    "skewed column": 4.383,
    "skewed BruteForce": 27.154,
}


# K10 before its redesign (the row DP, one thread per pair) through
# ``myers_pairs`` at phase 12(c)'s shapes, timed by tools/time_k10.py on
# the parent checkout on the same card type and limit (H100 80GB HBM3,
# 700.00 W): the mean of two runs
BEFORE_K10_MS = {"refine batch": 11.2886, "anchor column": 5.0819, "BruteForce": 116.5352}


def make_blobs(n_samples, n_features, centers, seed):
    """``sklearn.datasets.make_blobs(n_samples, n_features,
    centers=centers, random_state=seed)`` in numpy: the same draws from
    the same ``np.random.RandomState`` (cluster_std 1, center box
    (-10, 10), shuffled)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    C = rng.uniform(-10.0, 10.0, size=(centers, n_features))
    sizes = [n_samples // centers] * centers
    for i in range(n_samples % centers):
        sizes[i] += 1
    X = np.concatenate(
        [rng.normal(loc=C[i], scale=1.0, size=(n, n_features)) for i, n in enumerate(sizes)]
    )
    y = np.repeat(np.arange(centers), sizes)
    order = np.arange(n_samples)
    rng.shuffle(order)
    return X[order], y[order]


def mutate_strings(strings, rate, seed, alphabet="ACGT"):
    """Query copies of ``strings``: each character is replaced, with
    probability ``rate``, by a symbol drawn uniformly from ``alphabet``
    (which may be the same symbol), from ``np.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    out = []
    for s in strings:
        a = np.array(list(s))
        hit = rng.random(a.shape[0]) < rate
        a[hit] = rng.choice(chars, size=int(hit.sum()))
        out.append("".join(a))
    return out


def query_recall(ngi, R, k):
    """Distance-multiset recall of each query's first ``k`` reported
    neighbours ``ngi[q, :k]`` against its exact row ``R[q]`` (distances
    from query q to every database point): a different but equidistant
    neighbour counts as a hit, as in ``compare_neighbor_graphs``."""
    from collections import Counter

    import numpy as np

    hits = 0
    for q in range(R.shape[0]):
        d = R[q].astype(np.float64)
        exact = np.sort(np.partition(d, k - 1)[:k])
        got = ngi[q, :k]
        dg = np.where(got >= 0, d[np.clip(got, 0, None)], np.inf)
        hits += k - sum((Counter(exact.tolist()) - Counter(dg.tolist())).values())
    return hits / (R.shape[0] * k)


def _phase(name):
    print("== %s" % name, flush=True)


def _card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def _ptxas(kernel):
    """Registers and spills of each kernel instantiation, from ptxas -v
    in the build log: {"k1_group<32,1,1>": (registers, spill stores,
    spill loads)}."""
    import re

    table, name, spill = {}, None, (0, 0)
    for line in kernel.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kind = re.search(r"(k10?_thread|k10?_group|k10?_long|k4_tropical|k9a_band|"
                             r"k8a_resident|k8a_step|k8a_ones|k8a_sum|k8b_resident|k8b_step|"
                             r"k8b_cost|k8b_sum|k12_emd)", m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = "%s%s" % (kind.group(1) if kind else "?",
                             "<%s>" % ",".join(args) if args else "")
            name = name.replace("k9a_band<1>", "k9a_band<hist>").replace(
                "k9a_band<0>", "k9a_band<keep>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name] = (int(m.group(1)), *spill)
            name = None
    return table


def _random_strings(rng, n, lo, hi, alphabet):
    chars = list(alphabet)
    return [
        "".join(rng.choice(chars, size=int(rng.integers(lo, hi + 1))))
        for _ in range(n)
    ]


def _k1_against_plain(torch, np, name, strs, npairs, rng, tail=0):
    """K1 in each launch mode against the plain version on ``npairs``
    random pairs of ``strs`` (the first pairs on the diagonal), and on
    every pair of the last ``tail`` strings, bit for bit.  Returns
    max |K1 - plain|."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs_plain
    from annchor_tpu_torch.ops.levenshtein_cuda import myers_pairs_cuda

    enc = MyersEncoding.from_codes(*encode_strings(strs), "cuda")
    n = len(strs)
    I = torch.as_tensor(rng.integers(0, n, size=npairs), device="cuda")
    J = torch.as_tensor(rng.integers(0, n, size=npairs), device="cuda")
    I[: min(n, npairs)] = torch.arange(min(n, npairs), device="cuda")
    if tail:
        t = torch.arange(n - tail, n, device="cuda")
        I = torch.cat([I, t.repeat_interleave(tail)])
        J = torch.cat([J, t.repeat(tail)])
    want = myers_pairs_plain(enc, I, J)
    worst = 0
    for mode in ("auto", "thread", "group"):
        got = myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J, enc.wmax, mode,
                               wbulk=enc.wbulk)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        plans = _plan(enc, int(I.shape[0]), mode)
        print("  K1 vs plain  %-14s W=%d/%-3d pairs=%-6d %-6s -> %-18s max|diff|=%d"
              % (name, enc.wbulk, enc.wmax, I.shape[0], mode, _modes(plans), err),
              flush=True)
        if err != 0:
            raise SystemExit("K1 (%s) disagrees with its plain version on %s" % (mode, name))
        worst = max(worst, err)
    return worst


def _modes(plans):
    """The modes of a launch plan's launches, "group+thread+long"."""
    return "+".join(p.mode for p in plans)


def _skewed(X, rng):
    """strings-1600 with one 2,100-character string appended: 99 % of the
    strings still have at most 17 words, the new one 66."""
    return list(X) + ["".join(rng.choice(list("ACGT"), size=2100))]


def _check_no_sync(torch, np, X):
    """One K1 call in each mode, an anchor column (an expanded id), under
    ``torch.cuda.set_sync_debug_mode("error")``, on strings-1600 and on it
    with one long string (whose plan adds the overflow launches): none
    may wait for the card."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_cuda import myers_pairs_cuda
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding

    for name, strs in (("strings-1600", X), ("skewed", _skewed(X, np.random.default_rng(5)))):
        enc = MyersEncoding.from_codes(*encode_strings(strs), "cuda")
        I = torch.tensor(1126, device="cuda").expand(len(strs))
        J = torch.arange(len(strs), device="cuda")
        outs = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for mode in ("auto", "thread", "group"):
                outs.append(myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J, enc.wmax,
                                             mode, wbulk=enc.wbulk))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise SystemExit("K1's modes disagree on the %s anchor column" % name)
        print("  K1 under set_sync_debug_mode('error'), %s (%s): auto, thread, group ran "
              "with no sync" % (name, _modes(_plan(enc, len(strs)))), flush=True)


def _check_k1(torch, np, X):
    """K1 against the plain version on CUDA tensors, bit for bit.
    Returns (pairs compared, max |K1 - plain|)."""
    rng = np.random.default_rng(0)
    cases = []
    for alphabet in ("ab", "ACGT", "abcdefghijklmnopqrstuvwxyz"):
        strs = _random_strings(rng, 256, 0, 140, alphabet)
        strs[:7] = ["", "a" * 33] + [
            "".join(rng.choice(list(alphabet), size=k)) for k in (31, 32, 33, 64, 65)
        ]
        cases.append((alphabet, strs, 16_384))
    cases.append(("strings-1600", list(X), 20_000))
    cases.append(("W 40-48", _random_strings(rng, 48, 1249, 1536, "ACGT"), 2_048))
    cases.append(("W 63-64", _random_strings(rng, 48, 1985, 2048, "ACGT"), 2_048))
    cases.append(("W>64", _random_strings(rng, 48, 2100, 2300, "ACGT"), 2_048))
    # eight strings of 35-44 words and four of 66-72 after strings-1600:
    # the main launch holds 17 words, the pairs among the twelve overflow
    tail = (_random_strings(rng, 8, 1100, 1400, "ACGT")
            + _random_strings(rng, 4, 2100, 2300, "ACGT"))
    cases.append(("skewed", list(X) + tail, 6_740))
    total, worst = 0, 0
    for name, strs, npairs in cases:
        k = len(tail) if name == "skewed" else 0
        worst = max(worst, _k1_against_plain(torch, np, name, strs, npairs, rng, tail=k))
        total += npairs + k * k
    return total, worst


def _check_oracle(torch, np, X):
    """K1 against the pure-Python DP on 64 sampled strings-1600 pairs."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs

    rng = np.random.default_rng(1)
    enc = MyersEncoding.from_codes(*encode_strings(list(X)), "cuda")
    I = rng.integers(0, len(X), size=64)
    J = rng.integers(0, len(X), size=64)
    got = myers_pairs(
        enc, torch.as_tensor(I, device="cuda"), torch.as_tensor(J, device="cuda")
    ).tolist()
    want = [levenshtein_scalar(X[i], X[j]) for i, j in zip(I, J)]
    if got != want:
        raise SystemExit("K1 disagrees with the scalar oracle")
    print("  K1 vs scalar oracle: 64 strings-1600 pairs equal", flush=True)


def _cjk(size):
    """``size`` code points: CJK ideographs from U+4E00, the last 4,000
    astral ones from U+20000."""
    return ([chr(0x4E00 + i) for i in range(size - 4000)]
            + [chr(0x20000 + i) for i in range(4000)])


def _check_k10(torch, np):
    """K10 against its plain version (the row DP) on CUDA tensors, bit for
    bit, in each launch mode (auto, thread, group), both argument orders
    (int64 and int32 ids) and every call under
    ``torch.cuda.set_sync_debug_mode("error")``: 7,000 pairs over each of
    193, 256 and 1,000 symbols (the empty string, lengths 1-600 and one of
    2,100), and over 20,000 CJK and astral code points (the empty string,
    lengths 0-600, one string of 5,000 characters and one of 2,600, whose
    pairs run down the overflow lists into long mode), each set's self
    pairs included; then 64 of the pairs against the pure-Python DP.
    Returns (pairs compared, max |K10 - plain|, launches per mode)."""
    from annchor_tpu_torch.ops.levenshtein import (
        RowDPEncoding,
        encode_strings,
        lev_pairs_plain,
        levenshtein_scalar,
    )
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import K10, plan_for, rowdp_pairs_cuda

    rng = np.random.default_rng(2)
    total = worst = 0
    hits = []
    modes = dict.fromkeys(K10.mode_launches, 0)
    for size in (193, 256, 1000, 20_000):
        alphabet = np.array(_cjk(size) if size == 20_000
                            else [chr(0x100 + i) for i in range(size)])
        head = [0, 5000, 2600] if size == 20_000 else [0, 0, 1, 2, 2100]
        lens = np.concatenate([head, rng.integers(0 if size == 20_000 else 1, 601,
                                                  300 - len(head))])
        strs = ["".join(rng.choice(alphabet, size=int(k))) for k in lens]
        enc = MyersEncoding.from_codes(*encode_strings(strs), "cuda")
        if not isinstance(enc, RowDPEncoding):
            raise SystemExit("%d symbols did not give K10's encoding" % size)
        n = len(strs)
        I = torch.as_tensor(rng.integers(0, n, 7000), device="cuda")
        J = torch.as_tensor(rng.integers(0, n, 7000), device="cuda")
        # the head strings against each other: the empty string, and on
        # 20,000 symbols the long pair either way (long mode's work)
        head_pairs = (([0, 1, 2, 1, 0], [1, 2, 1, 1, 2]) if size == 20_000
                      else ([0, 1, 2, 3, 4], [1, 0, 4, 4, 0]))
        I[:5], J[:5] = (torch.tensor(v, device="cuda") for v in head_pairs)
        I = torch.cat([I, torch.arange(n, device="cuda")])  # self pairs
        J = torch.cat([J, torch.arange(n, device="cuda")])
        want = lev_pairs_plain(enc, I, J, chunk=1024)
        err = 0
        for mode in ("auto", "thread", "group"):
            before = dict(K10.mode_launches)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = rowdp_pairs_cuda(enc, I, J, mode)
                swapped = rowdp_pairs_cuda(enc, J.int(), I.int(), mode)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            for m in modes:
                modes[m] += K10.mode_launches[m] - before[m]
            err = max(err, int((got.long() - want.long()).abs().max()),
                      int((swapped.long() - want.long()).abs().max()))
        plans = plan_for(enc, int(I.shape[0]))
        print("  K10 vs plain  %5d symbols, lengths 0-%d, W %d/%d, pairs=%d x 2 orders x "
              "auto (%s), thread, group, no sync: max|diff|=%d"
              % (size, int(lens.max()), enc.wbulk, enc.wmax, I.shape[0], _modes(plans), err),
              flush=True)
        if err:
            raise SystemExit("K10 disagrees with its plain version (%d symbols)" % size)
        worst = max(worst, err)
        total += 6 * int(I.shape[0])
        for k in rng.choice(7000, 16, replace=False):
            i, j = int(I[k]), int(J[k])
            hits.append(int(got[k]) == levenshtein_scalar(strs[i], strs[j]))
    if not all(hits) or len(hits) != 64:
        raise SystemExit("K10 disagrees with the pure-Python DP")
    print("  K10 vs scalar oracle: %d pairs equal; launches by mode %s" % (len(hits), modes),
          flush=True)
    if not all(modes.values()):
        raise SystemExit("the K10 checks did not launch every mode: %s" % modes)
    return total, worst, modes


def _check_encode(torch, np, X):
    """The strings' encoding built on the card (``MyersEncoding.on_device``,
    what the metric engine runs there) against the host build
    (``from_codes`` of ``encode_strings``), every table and host size bit
    for bit, on strings-1600 ``X``, on a set of BMP and astral code points
    (lengths 0-600 and one of 2,100, NUL included) and on 193 symbols
    (the row DP's ``RowDPEncoding``); the card build's synchronising
    calls counted under ``set_sync_debug_mode("warn")`` (one, ``torch.unique``'s,
    for a ``MyersEncoding``), then both builds
    timed beside each other on strings-1600 (median of 15, synchronised).
    Returns {set: (host ms, card ms, syncs)}; the times only for
    strings-1600."""
    import warnings

    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding, encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding

    def host(strs):
        return MyersEncoding.from_codes(*encode_strings(strs), "cuda")

    def card(strs):
        return MyersEncoding.on_device(strs, "cuda")

    rng = np.random.default_rng(21)
    lens = np.concatenate([[0, 2100], rng.integers(0, 601, 198)])

    def over(symbols):
        return ["".join(symbols[i] for i in rng.integers(0, len(symbols), int(k)))
                for k in lens]

    sets = {
        "strings-1600": X,
        "astral": over([chr(0x20000 + i) for i in range(40)] + ["a", "\x00", "\u00e9"]),
        "193 symbols": over(_cjk(4193)[100:293]),
    }
    out = {}
    for name, strs in sets.items():
        want = host(strs)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = card(strs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
        if type(got) is not type(want) or (name == "193 symbols") != isinstance(
                got, RowDPEncoding):
            raise SystemExit("%s: the card build gave a %s, the host build a %s"
                             % (name, type(got).__name__, type(want).__name__))
        for slot in type(want).__slots__:
            a, b = getattr(got, slot), getattr(want, slot)
            same = (a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
                    if isinstance(b, torch.Tensor) else a == b)
            if not same:
                raise SystemExit("%s: the card build's %s differs from the host build's"
                                 % (name, slot))
        if not isinstance(got, RowDPEncoding) and syncs != 1:
            raise SystemExit("%s: the card build synchronised %d times; torch.unique's "
                             "read of the alphabet is its one" % (name, syncs))
        host_ms = card_ms = float("nan")
        if name == "strings-1600":
            times = {}
            for label, fn in (("host", host), ("card", card), ("card", card), ("host", host)):
                for _ in range(15):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(strs)
                    torch.cuda.synchronize()
                    times.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            host_ms, card_ms = (float(np.median(times[k])) for k in ("host", "card"))
        out[name] = (host_ms, card_ms, syncs)
        print("  encoding %-12s %4d strings, %s%s: card build bit-equal to the host build, "
              "%d synchronising call(s); host %.3f ms, card %.3f ms" % (
                  name, len(strs), type(got).__name__,
                  "" if isinstance(got, RowDPEncoding) else " (%d symbols, W %d)"
                  % (got.alphabet, got.W), syncs, host_ms, card_ms), flush=True)
    return out


def _bit_err(torch, got, want):
    """max |got - want| over the entries that differ (0 when bit-equal;
    equal infinities count as equal)."""
    got, want = got.float(), want.float()
    diff = torch.where(got == want, torch.zeros_like(got), (got - want).abs())
    return float(diff.nan_to_num(float("inf")).max()) if diff.numel() else 0.0


def _capture_tighten(torch, att, X):
    """(E, V, Einf) of each dense tighten of phase 4's strings-1600 fit,
    cloned as the fit hands them to ``device_pipeline.tropical_product``."""
    from annchor_tpu_torch.ops import device_pipeline as dp

    seen = []
    real = dp.tropical_product

    def capture(E, V, Einf, y0, y1, block=16):
        seen.append((E.clone(), V.clone(), Einf.clone()))
        return real(E, V, Einf, y0, y1, block)

    dp.tropical_product = capture
    try:
        att.Annchor(X, "levenshtein", n_neighbors=N_NEIGHBORS, p_work=P_WORK,
                    random_seed=42, device="cuda").fit()
    finally:
        dp.tropical_product = real
    return seen


def _k4_matrix(torch, np, nx, density, computed=1.0, empty_rows=0, full=False, seed=0):
    """(E, V, Einf) as ``tighten_full`` builds them from a random state:
    ``density`` of the pairs i < j tracked, ``computed`` of those
    computed, none in the first ``empty_rows`` rows; ``full``: every
    entry present, the diagonal too.  Integer and arbitrary float32
    distances."""
    from annchor_tpu_torch.ops.bounds_update import _build_E

    rng = np.random.default_rng(seed + nx)
    if full:
        E = torch.as_tensor((rng.random((nx, nx)) * 400).astype(np.float32), device="cuda")
        E = torch.minimum(E, E.T).contiguous()
        V = torch.ones((nx, nx), dtype=torch.bool, device="cuda")
    else:
        iu, ju = np.triu_indices(nx, 1)
        keep = rng.random(iu.size) < density
        IJ = torch.as_tensor(np.stack([iu[keep], ju[keep]], axis=1), device="cuda")
        m = IJ.shape[0]
        RA = np.where(rng.random(m) < 0.5, rng.integers(0, 400, m), rng.random(m) * 400)
        done = (rng.random(m) < computed) & (iu[keep] >= empty_rows) & (ju[keep] >= empty_rows)
        E, V = _build_E(IJ, torch.as_tensor(RA.astype(np.float32), device="cuda"),
                        torch.as_tensor(done, device="cuda"), nx)
    return E, V, torch.where(V, E, torch.full_like(E, float("inf")))


def _check_k4(torch, np, att, X):
    """K4 against its plain version (``tropical_product_plain``) on CUDA
    tensors, bit for bit, each kernel call under
    ``torch.cuda.set_sync_debug_mode("error")``: nx 1 and 17, 1,000 (not a
    multiple of the 64-point tile), 300 with 40 rows that have no computed
    entry, 257 with every entry present (the diagonal too), strings-1600's
    E at both dense tightens of its fit (every column, a sub-range, and two
    sub-ranges whose max and min make the whole), and 4,096.  Returns
    (calls compared, max |K4 - plain|, launches, the fit's last E)."""
    from annchor_tpu_torch.ops import device_pipeline as dp
    from annchor_tpu_torch.ops.tropical_cuda import K4

    fit = _capture_tighten(torch, att, X)
    if len(fit) != 2:
        raise SystemExit("strings-1600's fit ran %d dense tightens, not 2" % len(fit))
    cases = [("nx 1", _k4_matrix(torch, np, 1, 1.0)),
             ("nx 17", _k4_matrix(torch, np, 17, 0.8, 0.5)),
             ("nx 1000", _k4_matrix(torch, np, 1000, 0.2, 0.5)),
             ("40 empty rows", _k4_matrix(torch, np, 300, 0.5, 0.5, empty_rows=40)),
             ("every entry", _k4_matrix(torch, np, 257, 1.0, full=True)),
             ("strings-1600 tighten 1", fit[0]),
             ("strings-1600 tighten 2", fit[1]),
             ("nx 4096", _k4_matrix(torch, np, 4096, 0.05))]
    calls = worst = 0
    before = K4.launches
    for name, (E, V, Einf) in cases:
        nx = E.shape[0]
        a, b = nx // 3, (2 * nx) // 3 + 1
        ranges = ([(0, nx), (a, b), (0, a), (a, nx)] if name.startswith("strings")
                  else [(0, nx)])
        got = {}
        for y0, y1 in ranges:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got[y0, y1] = dp.tropical_product(E, V, Einf, y0, y1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = dp.tropical_product_plain(E, V, Einf, y0, y1)
            err = max(_bit_err(torch, g, w) for g, w in zip(got[y0, y1], want))
            same = all(torch.equal(g, w) for g, w in zip(got[y0, y1], want))
            worst = max(worst, err)
            calls += 1
            if not same:
                raise SystemExit("K4 disagrees with its plain version: %s, columns %d..%d "
                                 "(max|diff| %g)" % (name, y0, y1, err))
        split = len(ranges) > 1 and torch.equal(
            torch.maximum(got[0, a][0], got[a, nx][0]), got[0, nx][0]) and torch.equal(
            torch.minimum(got[0, a][1], got[a, nx][1]), got[0, nx][1])
        print("  K4 vs plain  %-22s nx %4d, %5.1f %% of entries present, columns %s, no "
              "sync: bit-equal%s" % (
                  name, nx, 100 * float(V.float().mean()),
                  ", ".join("%d..%d" % r for r in ranges),
                  "; the two sub-ranges combine to the whole" if split else ""), flush=True)
        if len(ranges) > 1 and not split:
            raise SystemExit("K4's two column sub-ranges do not combine to the whole")
    launches = K4.launches - before
    if launches != calls:
        raise SystemExit("K4 launched %d times for %d calls" % (launches, calls))
    return calls, worst, launches, fit[1]


def _k9a_problem(torch, np, na, nx=5000, nxp=6144, seed=0):
    """The band build's padded operands (``candidate_pairs_device_budgeted``)
    on the card: D32p (nxp, na) of integer and arbitrary float32 anchor
    distances, Sp, effp (+inf on padding, 10 % of the rows 0: ROADMAP F6),
    inv_bin over 256 bins, and pass-2 thresholds with 0 and +inf."""
    from annchor_tpu_torch.ops.features import anchor_membership

    rng = np.random.default_rng(seed + na)
    D = np.where(rng.random((nx, na)) < 0.5, rng.integers(0, 400, (nx, na)),
                 rng.random((nx, na)) * 400).astype(np.float32)
    S, _ = anchor_membership(D, min(5, na), "cuda")
    eff = rng.integers(1, 4, nx).astype(np.float32)
    eff[rng.random(nx) < 0.1] = 0.0
    pad = nxp - nx
    F = torch.nn.functional
    thr = rng.choice(np.array([0.0, 50.0, 120.5, 200.0, 400.0, np.inf], dtype=np.float32), nxp)
    return dict(nx=nx, D32p=F.pad(torch.as_tensor(D, device="cuda"), (0, 0, 0, pad)),
                Sp=F.pad(S, (0, 0, 0, pad)),
                effp=F.pad(torch.as_tensor(eff, device="cuda"), (0, pad), value=float("inf")),
                inv_bin=torch.tensor(np.float32(256 / (2.0 * float(D.max()) + 1e-6)),
                                     device="cuda"),
                thr=torch.as_tensor(thr, device="cuda"))


def _check_k9a(torch, np):
    """K9a against its plain versions (``_band_hist_sym_plain``,
    ``_band_keep2_plain``) on CUDA tensors, bit for bit, each dispatch
    under ``torch.cuda.set_sync_debug_mode("error")``: 5,000 points padded
    to 6,144 in bands of 2,048 (padding rows and columns), 10 % of the rows
    at effective threshold 0, pass-2 thresholds with 0 and +inf, every band
    in both modes at na 5, 32, 48, 96 and 160 (5 words of bits a point,
    past the 4 held in registers), and the last band against 5,001
    columns (a ragged chunk: not a multiple of the tile or of 4); the
    thresholds from each histogram (``_band_thr_from_hist``) bit for bit
    the plain bins' bisection (``_band_thr_from_bins``) at caps 1, 15 and
    200.  Returns (calls compared, max |K9a - plain|, launches per
    mode)."""
    from annchor_tpu_torch.ops import band_linf_cuda, locality
    from annchor_tpu_torch.ops.band_linf_cuda import K9A

    before = dict(K9A.mode_launches)
    calls = worst = 0
    for na in (5, 32, 48, 96, 160):
        P = _k9a_problem(torch, np, na)
        D32p, Sp, effp, inv, thr = P["D32p"], P["Sp"], P["effp"], P["inv_bin"], P["thr"]
        bin_w = 1.0 / inv
        nxp = D32p.shape[0]
        kept = counted = 0
        for cols, r0s in ((nxp, range(0, nxp, 2048)), (5001, [4096])):
            ops = band_linf_cuda.operands(D32p[:cols], Sp[:cols])
            for r0 in r0s:
                args = (D32p[:cols], Sp[:cols], Sp[r0 : r0 + 2048], D32p[r0 : r0 + 2048],
                        effp[r0 : r0 + 2048], effp[:cols])
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    hist = locality._band_hist_sym(*args, r0, P["nx"], inv, 256, 2048,
                                                   cols=ops)
                    keep = locality._band_keep2_dense(*args, thr, r0, P["nx"], 2048,
                                                      cols=ops)[0]
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                want_h = locality._band_hist_sym_plain(*args, r0, P["nx"], inv, 256, cols)
                want_k = locality._band_keep2_plain(*args, thr, r0, P["nx"], cols)
                bins = locality._band_bins_sym_plain(*args, r0, P["nx"], inv, 256, cols)
                thr_equal = all(torch.equal(
                    locality._band_thr_from_hist(hist, cap, bin_w),
                    locality._band_thr_from_bins(bins, cap, bin_w, 256)) for cap in (1, 15, 200))
                err = max(_bit_err(torch, hist, want_h), _bit_err(torch, keep, want_k))
                worst = max(worst, err)
                calls += 2
                if not (torch.equal(hist, want_h) and torch.equal(keep, want_k) and thr_equal):
                    raise SystemExit("K9a disagrees with its plain version: na %d, rows "
                                     "%d.., %d columns (max|diff| %g, thresholds equal %s)"
                                     % (na, r0, cols, err, thr_equal))
                counted += int(hist.sum())
                kept += int(keep.sum())
        print("  K9a vs plain na %2d: 3 bands of 2,048 x 6,144 and one of 2,048 x 5,001, "
              "hist and keep, no sync: bit-equal, thresholds bit-equal to the bisection "
              "(%d pairs counted, %d kept)" % (na, counted, kept), flush=True)
    launches = {m: K9A.mode_launches[m] - before[m] for m in before}
    if launches != {"hist": calls // 2, "keep": calls // 2}:
        raise SystemExit("K9a launched %s for %d calls" % (launches, calls))
    return calls, worst, launches


@contextlib.contextmanager
def _capture_bands():
    """Within the block, record the operands of the single-device budgeted
    band build as it hands them to ``locality._band_thresholds`` and
    ``_band_keep2_dense`` (the first build only): the padded D32p, Sp and
    effp, nx, inv_bin, bin_w, nbins, the cap, the band height and column
    chunk, and pass 2's thresholds.  They are references, not copies: the
    build writes none of them after pass 1."""
    from annchor_tpu_torch.ops import locality

    seen = {}
    real_thr, real_keep = locality._band_thresholds, locality._band_keep2_dense

    def thresholds(*a, **kw):
        if "D32p" not in seen:
            seen.update(D32p=a[0], Sp=a[1], nblk=a[2].shape[0], effp=a[5], nx=a[7],
                        inv_bin=a[8], bin_w=a[9], nbins=a[10], cap=a[11], cchunk=a[12])
        return real_thr(*a, **kw)

    def keep(*a, **kw):
        seen.setdefault("thr", a[6])
        return real_keep(*a, **kw)

    locality._band_thresholds, locality._band_keep2_dense = thresholds, keep
    try:
        yield seen
    finally:
        locality._band_thresholds, locality._band_keep2_dense = real_thr, real_keep


def _check_k9a_bands(torch, np, cap):
    """K9a on bands the 100k build launched (``cap``, from
    ``_capture_bands``): its first and last band, 4,096 rows against all
    102,400 columns, through the dispatch points ``_band_hist_sym`` and
    ``_band_keep2_dense`` under ``torch.cuda.set_sync_debug_mode("error")``,
    held bit for bit to ``_band_hist_sym_plain`` and ``_band_keep2_plain``,
    and the band's thresholds (``_band_thresholds``: the histogram, then
    ``_band_thr_from_hist``) bit for bit to the plain bins' bisection
    (``_band_thr_from_bins``, the JAX package's way) at the build's cap.
    Then the wrapper (``band_linf_cuda.band_hist``, ``band_keep``) timed
    in each mode on both bands by CUDA events beside its bound
    (``_k9a_bound``: the steps of the pairs the pass admits), with the
    plain version's ms and ``torch.cdist(Db, D32p, p=inf)``'s, and pass
    1's whole threshold on the card (``thr_ms``) beside the plain bins and
    their bisection (``thr_plain_ms``).  Returns the rows; the first
    band's are the kernels line's K9a figures."""
    from annchor_tpu_torch.ops import band_linf_cuda, locality

    if not {"D32p", "thr"} <= set(cap):
        raise SystemExit("the 100,000-string fit ran no budgeted band build")
    D32p, Sp, effp, thr = cap["D32p"], cap["Sp"], cap["effp"], cap["thr"]
    nx, nblk, cchunk, nbins, inv = cap["nx"], cap["nblk"], cap["cchunk"], cap["nbins"], \
        cap["inv_bin"]
    bin_w, per_point = cap["bin_w"], cap["cap"]
    nxp, na = D32p.shape
    cols = band_linf_cuda.operands(D32p, Sp)
    rows = {}
    for name, r0 in (("first", 0), ("last", nxp - nblk)):
        args = (D32p, Sp, Sp[r0 : r0 + nblk], D32p[r0 : r0 + nblk], effp[r0 : r0 + nblk], effp)
        kernels = {
            "hist": lambda: locality._band_hist_sym(*args, r0, nx, inv, nbins, cchunk, "linf",
                                                    cols),
            "keep": lambda: locality._band_keep2_dense(*args, thr, r0, nx, cchunk, "linf",
                                                       cols)[0]}
        plains = {
            "hist": lambda: locality._band_hist_sym_plain(*args, r0, nx, inv, nbins, cchunk),
            "keep": lambda: locality._band_keep2_plain(*args, thr, r0, nx, cchunk)}
        thr_card = lambda: locality._band_thresholds(  # noqa: E731
            *args, r0, nx, inv, bin_w, nbins, per_point, cchunk, "linf", cols)
        thr_plain = lambda: locality._band_thr_from_bins(  # noqa: E731
            locality._band_bins_sym_plain(*args, r0, nx, inv, nbins, cchunk), per_point, bin_w,
            nbins)
        got = {}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for mode, fn in kernels.items():
                got[mode] = fn()
            got_thr = thr_card()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(got_thr, thr_plain()):
            raise SystemExit("K9a's thresholds from the histogram differ from the bisection "
                             "of the plain bins on the 100k build's %s band" % name)
        binned = locality._band_bins_sym_plain(*args, r0, nx, inv, nbins, cchunk) < nbins
        # the share of K9a's 64 x 64 tiles that hold an admitted pair
        tiles = torch.nn.functional.pad(binned.to(torch.uint8), (0, -nxp % 64, 0, -nblk % 64))
        occupied = float(tiles.view(-(-nblk // 64), 64, -1, 64).amax(dim=3).amax(dim=1)
                         .float().mean())
        # the wrapper alone, as the dispatch calls it
        band = band_linf_cuda.operands(args[3], args[2])
        wrappers = {
            "hist": lambda: band_linf_cuda.band_hist(band, args[4], cols, effp, r0, nx, inv,
                                                     nbins),
            "keep": lambda: band_linf_cuda.band_keep(band, args[4], thr[r0 : r0 + nblk], cols,
                                                     effp, thr, r0, nx)}
        library_ms = _time(torch, lambda: torch.cdist(args[3], D32p, p=float("inf")), 2)
        for mode, fn in wrappers.items():
            want = plains[mode]()
            err = _bit_err(torch, got[mode], want)
            if not torch.equal(got[mode], want):
                raise SystemExit("K9a disagrees with its plain version on the 100k build's "
                                 "%s band, %s mode (max|diff| %g)" % (name, mode, err))
            rows["K9a %s %s" % (mode, name)] = {
                "shape": [nblk, nxp, na], "row_off": r0, "max_abs_err": err,
                "ms": _time(torch, fn, 10), "plain_ms": _time(torch, plains[mode], 1),
                **_k9a_bound(torch, np, binned, na, r0, nx, mode, nbins),
                "library_ms": library_ms, "tiles_admitting": occupied}
            del want
        rows["K9a hist %s" % name].update(thr_ms=_time(torch, thr_card, 10),
                                          thr_plain_ms=_time(torch, thr_plain, 1))
        del got, binned
    print("  K9a on the 100k build's first and last band (rows %d.. and %d.., %d columns, "
          "na %d), hist and keep, no sync: bit-equal to the plain versions, thresholds "
          "bit-equal to the bisection" % (0, nxp - nblk, nxp, na), flush=True)
    _print_rows(rows)
    for key, row in rows.items():
        print("    %s: %d pairs admitted of %d the masks leave; %.1f %% of the band's "
              "64 x 64 tiles hold a pair pass 1 admits%s" % (
                  key, row["pairs_admitted"], row["pairs_dense"],
                  100 * row["tiles_admitting"], "; pass 1's thresholds %.4f ms (plain bins "
                  "and bisection %.3f ms)" % (row["thr_ms"], row["thr_plain_ms"])
                  if "thr_ms" in row else ""), flush=True)
    return rows


def _k4_k9a_timing(torch, np, E1600=None):
    """K4 over every column at nx 1,600 (``E1600``: strings-1600's E at its
    fit's second tighten, or a random one) and 4,096, and K9a on a
    (4096, 2048, 96) chunk of random profiles in both modes (phase 9(c)'s
    rms chunk; phase 9(b) times the 100k build's own bands): ms by CUDA
    events beside the bound (``FMNMX_PER_S``) and its share, the plain
    version's ms, and for K9a the rms score's ms and
    ``torch.cdist(Db, Dc, p=inf)``'s (``library_ms``: the one PyTorch
    call of the same score, never on the port's path).  Each kernel is
    held to its plain version once more.  Returns the rows."""
    from annchor_tpu_torch.ops import band_linf_cuda, locality
    from annchor_tpu_torch.ops import device_pipeline as dp
    from annchor_tpu_torch.ops.features import anchor_membership

    rows = {}
    for nx, EVI in ((1600, E1600), (4096, None)):
        E, V, Einf = EVI if EVI is not None else _k4_matrix(torch, np, nx, 0.05)
        got = dp.tropical_product(E, V, Einf, 0, nx)
        want = dp.tropical_product_plain(E, V, Einf, 0, nx)
        # 2 FMNMX for each (i <= j, y) with both entries present
        present = V.sum(dim=0, dtype=torch.int64).double()
        ops_ms = float((present * (present + 1)).sum()) / FMNMX_PER_S * 1e3
        dense_ms = nx * (nx + 1) / 2 * nx * 2 / FMNMX_PER_S * 1e3
        bytes_ms = nx * nx * (4 + 1 + 2 * 4) / HBM_BYTES_PER_S * 1e3  # E, V; LB, UB
        row = {"nx": nx, "max_abs_err": max(_bit_err(torch, g, w) for g, w in zip(got, want)),
               "ms": _time(torch, lambda: dp.tropical_product(E, V, Einf, 0, nx), 20),
               "plain_ms": _time(torch, lambda: dp.tropical_product_plain(E, V, Einf, 0, nx),
                                 2),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "bound_ms_dense": max(dense_ms, bytes_ms),
               "library_ms": None}
        rows["K4 nx %d" % nx] = row

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C, na = 4096, 2048, 96
    Db = torch.rand((B, na), generator=gen, device="cuda") * 400
    Dc = torch.rand((C, na), generator=gen, device="cuda") * 400
    Sb, _ = anchor_membership(Db, 5, "cuda")
    Sc, _ = anchor_membership(Dc, 5, "cuda")
    eb = torch.randint(1, 4, (B,), generator=gen, device="cuda").float()
    ec = torch.randint(1, 4, (C,), generator=gen, device="cuda").float()
    thr = torch.rand((B,), generator=gen, device="cuda") * 400
    inv = torch.tensor(np.float32(256 / 800.0), device="cuda")
    rows_op = band_linf_cuda.operands(Db, Sb)
    cols_op = band_linf_cuda.operands(Dc, Sc)
    # rows and columns numbered from 0, as the plain loop numbers columns
    side = (Dc, Sc, Sb, Db, eb, ec)
    calls = {
        "hist": (lambda: band_linf_cuda.band_hist(rows_op, eb, cols_op, ec, 0, C, inv, 256),
                 lambda: locality._band_hist_sym_plain(*side, 0, C, inv, 256, C)),
        "keep": (lambda: band_linf_cuda.band_keep(rows_op, eb, thr, cols_op, ec, thr[:C], 0, C),
                 lambda: locality._band_keep2_plain(*side, thr, 0, C, C)),
    }
    library_ms = _time(torch, lambda: torch.cdist(Db, Dc, p=float("inf")), 20)
    rms_ms = _time(torch, lambda: locality._band_score(Db, Dc, "rms"), 20)
    binned = locality._band_bins_sym_plain(*side, 0, C, inv, 256, C) < 256
    for mode, (kernel, plain) in calls.items():
        row = {"shape": [B, C, na], "max_abs_err": _bit_err(torch, kernel(), plain()),
               "ms": _time(torch, kernel, 50), "plain_ms": _time(torch, plain, 5),
               **_k9a_bound(torch, np, binned, na, 0, C, mode),
               "library_ms": library_ms, "rms_ms": rms_ms}
        rows["K9a %s" % mode] = row
    _print_rows(rows)
    return rows


def _print_rows(rows):
    """Print timing rows (``_k4_k9a_timing``, ``_check_k9a_bands``) and
    fail on any that disagrees with its plain version."""
    for name, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        dense = row["bound_ms_dense"]
        print("  %-14s %-18s %9.4f ms | bound %.4f ms (%s), %.1f %% of it; dense %.4f ms, "
              "%.1f %% | plain %.3f ms | %s | max|diff| %g" % (
                  name, "nx %d" % row["nx"] if "nx" in row else "%d x %d x %d" % tuple(
                      row["shape"]), row["ms"], row["bound_ms"], row["bound_by"],
                  100 * row["bound_share"], dense, 100 * dense / row["ms"], row["plain_ms"],
                  "library: none" if row["library_ms"] is None else
                  "cdist p=inf %.3f ms%s" % (row["library_ms"], (
                      ", rms score %.3f ms" % row["rms_ms"]) if "rms_ms" in row else ""),
                  row["max_abs_err"]), flush=True)
        if row["max_abs_err"]:
            raise SystemExit("%s disagrees with its plain version" % name)


def _k9a_bound(torch, np, binned, na, row_off, nx, mode, nbins=256):
    """K9a's bound for one launch of a (B, C) band whose first row is
    point ``row_off``: the larger of its FMNMX, one for each anchor of a
    pair the pass admits (``binned``, pass 1's admitted mask of the same
    band; pass 2 admits its pairs above the diagonal), and its bytes, the
    operands read once (distances, bits, thresholds) and the output
    written once (hist: B x nbins int32; keep: B x C bool).
    ``bound_ms_dense`` counts instead every pair the pass's masks leave
    before the shared-anchor filter (every real column but the row's own,
    or in pass 2 above it): the steps a kernel that scores before it
    filters must do.  Returns a dict of both, the bound's kind and the
    pair counts."""
    B, C = binned.shape
    real = min(C, nx)
    r = row_off + np.arange(B, dtype=np.int64)
    if mode == "hist":
        admitted = int(binned.sum())
        dense = B * real - int(((r >= 0) & (r < real)).sum())
    else:
        cols = torch.arange(C, device=binned.device)
        rows = torch.arange(row_off, row_off + B, device=binned.device)
        admitted = int((binned & (cols[None, :] > rows[:, None])).sum())
        dense = int(np.maximum(real - r - 1, 0).sum())
    words = -(-na // 32)
    side = na * 4 + words * 4 + 4 + (4 if mode == "keep" else 0)
    nbytes = (B + C) * side + (B * nbins * 4 if mode == "hist" else B * C)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = admitted * na / FMNMX_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_dense": max(dense * na / FMNMX_PER_S * 1e3, bytes_ms),
            "pairs_admitted": admitted, "pairs_dense": dense}


def _check_small_fit(torch, np):
    """A small fit on the card equals the same fit on the CPU."""
    from annchor_tpu_torch import Annchor
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.device_pipeline import default_uniforms

    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)

    def uniforms(seed, loop, m, device):
        return default_uniforms(seed, loop, m, "cpu").to(device)

    fits = []
    for dev in ("cpu", "cuda"):
        ann = Annchor(list(X), "levenshtein", device=dev, uniforms=uniforms, **kw)
        ann.fit()
        fits.append(ann)
    a, b = fits
    same = (
        np.array_equal(a.A, b.A)
        and a.evals == b.evals
        and np.array_equal(a.neighbor_graph[0], b.neighbor_graph[0])
        and np.array_equal(a.neighbor_graph[1], b.neighbor_graph[1])
    )
    if not same:
        raise SystemExit("the small fit differs between the card and the CPU")
    print("  small fit (n=300): card == CPU, %d evals" % b.evals, flush=True)


def _check_scout_no_sync(torch, np):
    """The hybrid's certify dispatch: the Sinkhorn scout's values of
    40,000 digit pairs queued on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` (the table upload done
    first), then held against the same engine on the CPU on 2,000 of the
    pairs.  The card rounds each float64 product once, as the CPU does,
    but sums in another order, so the two agree to a few float32 ulps
    (rtol 2e-6)."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops.wasserstein import SinkhornExpEngine

    X, _ = digit_images()
    M = grid_cost_matrix()
    IJ = np.random.default_rng(4).integers(0, len(X), size=(40_000, 2))
    eng = SinkhornExpEngine(M, device="cuda")
    eng.dispatch(X, X, IJ[:10])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev, m = eng.dispatch(X, X, IJ)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = dev.cpu().numpy().astype(np.float64)
    want = SinkhornExpEngine(M, device="cpu")(X, X, IJ[:2000])
    rel = float(np.max(np.abs(got[:2000] - want) / np.abs(want)))
    print("  Sinkhorn scout dispatch of %d pairs under set_sync_debug_mode('error'): no sync; "
          "card vs CPU on 2,000 pairs: max relative difference %.3g" % (m, rel), flush=True)
    if m != IJ.shape[0] or not np.isfinite(got).all() or rel > 2e-6:
        raise SystemExit("the Sinkhorn scout on the card disagrees with the CPU")
    return rel


def _k8_digits(np):
    """The digits (1,797 x 64, the grid cost) with their first 16 rows
    replaced: 8 all-zero rows (``unit_mass`` keeps them zero) and 8 of one
    bin each."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix

    X = digit_images()[0].astype(np.float32)
    X[:16] = 0
    X[np.arange(8, 16), np.arange(8) * 7] = 5
    return X, grid_cost_matrix()


def _k8_random(np, n, m, seed):
    """m random histograms of n bins (30 % zero bins) with the same
    special rows as ``_k8_digits``, and a random asymmetric cost."""
    rng = np.random.default_rng(seed)
    X = (rng.random((m, n)) * (rng.random((m, n)) < 0.7)).astype(np.float32)
    X[:16] = 0
    X[np.arange(8, 16), (np.arange(8) * 7) % n] = 5
    return X, (rng.random((n, n)) * 10).astype(np.float32)


def _k8_pairs(np, m, B, seed):
    """B random pairs of m rows, the first ones self pairs and pairs of
    the all-zero and one-bin rows."""
    edge = np.array([(0, 0), (0, 20), (20, 0), (8, 8), (8, 9), (9, 30), (3, 12), (40, 40)])
    IJ = np.random.default_rng(seed).integers(0, m, size=(B, 2))
    IJ[: min(B, len(edge))] = edge[:B]
    return IJ


def _k8_compare(torch, got, want):
    """K8 against its plain version: the largest relative difference (the
    plain version's zeros must be met exactly), the largest absolute one,
    the share of bit-equal values and whether every value is finite where
    it is not the plain version's own (an all-zero histogram's pair can
    overflow to the same inf in both)."""
    g, w = got.double(), want.double()
    same = got == want
    diff = torch.where(same, 0.0, (g - w).abs())
    nz = w != 0
    return {"max_rel": float((diff[nz] / w[nz].abs()).max()) if bool(nz.any()) else 0.0,
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "bit_equal_share": float(same.double().mean()) if got.numel() else 1.0,
            "zeros_equal": bool((diff[~nz] == 0).all()),
            "finite": bool((torch.isfinite(g) | same).all())}


def _log_plan_name(plan):
    """K8b's plan in a few words: path, thread tile (outputs x pairs),
    pairs a block or tile."""
    return "%s %dx%d P %d" % (plan["path"], plan["C"], plan["R"], plan["P"])


def _no_sync(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _check_k8(torch, np):
    """Phase 2's K8 check.  K8a against its plain version to ``K8A_RTOL``
    and against its torch model (``sinkhorn_cuda.exp_chunk_model``) bit
    for bit: the digits (with all-zero rows, one-bin rows and self pairs)
    at n_iter 1, 2 and 300 on 1, 256, 1,797 (an anchor column: one id
    expanded with stride 0) and 8,192 pairs, the column and the chunk also
    on the streamed path; random asymmetric costs at n 5 (8,192 pairs,
    also streamed in every tile), 100, 144 (the most bins resident), 145
    and 300 (streamed), 784 (28 x 28 images), 2,100 and 7,200 (K read by
    column tiles); the engine's dispatch of 9,000 pairs (a ragged last
    chunk of 808).  K8b against its plain version to ``K8B_RTOL`` and
    against its torch model (``sinkhorn_cuda.log_batch_model``) bit for
    bit: the digits at n_iter 1, 2 and 200 on 1, 256 and 4,096 pairs and
    random costs at n 5, 100, 224 (resident), 300, 784 and 14,401
    (streamed, 2 n_iter + 2 launches).  Every kernel call under
    ``set_sync_debug_mode("error")``, with exactly the plan's launches
    (``exp_launches``, ``log_launches``).  Returns (calls, largest
    absolute difference, rows)."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    dev = torch.device("cuda")
    rows = []

    def exp_case(label, Xd, I, J, K, KC, n_iter, force=None):
        before = sc.K8.mode_launches["exp"]
        plan = sc.exp_plan(int(I.shape[0]), int(Xd.shape[1]), *(force or ()))
        got = _no_sync(torch, lambda: sc.sinkhorn_exp_cuda(
            Xd, Xd, I, J, K, KC, n_iter, w.TINY, _plan=plan) if force else
            w.sinkhorn_exp_chunk(Xd, Xd, I, J, K, KC, n_iter))
        launched = sc.K8.mode_launches["exp"] - before
        row = _k8_compare(torch, got, w.sinkhorn_exp_chunk_plain(Xd, Xd, I, J, K, KC, n_iter))
        row.update(kernel="K8a", case=label, n_iter=n_iter, launches=launched,
                   plan="%s %d x %d" % (plan["path"], plan["P"], plan["cols"]),
                   model_equal=bool(torch.equal(got, sc.exp_chunk_model(
                       Xd, Xd, I, J, K, KC, n_iter, w.TINY))))
        row["ok"] = (launched == sc.exp_launches(plan, n_iter) and row["finite"]
                     and row["zeros_equal"] and row["max_rel"] <= K8A_RTOL
                     and row["model_equal"])
        rows.append(row)

    def log_case(label, A, B, C, eps, n_iter):
        before = sc.K8.mode_launches["log"]
        got = _no_sync(torch, lambda: w.sinkhorn_batch(A, B, C, eps, n_iter))
        launched = sc.K8.mode_launches["log"] - before
        plan = sc.log_plan(int(A.shape[0]), int(A.shape[1]))
        row = _k8_compare(torch, got, w.sinkhorn_batch_plain(A, B, C, eps, n_iter))
        row.update(kernel="K8b", case=label, n_iter=n_iter, launches=launched,
                   plan=_log_plan_name(plan),
                   model_equal=bool(torch.equal(got, sc.log_batch_model(A, B, C, eps, n_iter))))
        # exactly the plan's launches: 1 resident, 2 n_iter + 2 streamed
        row["ok"] = (launched == sc.log_launches(plan, n_iter) and row["finite"]
                     and row["zeros_equal"] and row["max_rel"] <= K8B_RTOL
                     and row["model_equal"])
        rows.append(row)

    X, M = _k8_digits(np)
    eng = w.SinkhornExpEngine(M, device="cuda")
    Xd = eng._table(X)
    for B in (1, 256, 1797, 8192):
        if B == 1797:  # an anchor column, as sinkhorn_maxmin passes it
            I = torch.tensor(1126, device=dev).expand(B)
            J = torch.arange(B, device=dev)
        else:
            IJ = torch.as_tensor(_k8_pairs(np, len(X), B, B), device=dev)
            I, J = IJ[:, 0], IJ[:, 1]
        for n_iter in (1, 2, 300):
            exp_case("digits B %d" % B, Xd, I, J, eng._K, eng._KC, n_iter)
        if B in (1797, 8192):
            exp_case("digits B %d, streamed" % B, Xd, I, J, eng._K, eng._KC, 300, ("streamed",))
    for n, B in ((5, 256), (5, 8192), (100, 256), (100, 8192), (144, 8192), (145, 256),
                 (300, 256), (300, 8192), (784, 1000), (2100, 4), (7200, 5)):
        Xr, Cr = _k8_random(np, n, 2000, n)
        er = w.SinkhornExpEngine(Cr, device="cuda")
        IJ = torch.as_tensor(_k8_pairs(np, len(Xr), B, B + n), device=dev)
        Xrd = er._table(Xr)
        exp_case("random n %d B %d" % (n, B), Xrd, IJ[:, 0], IJ[:, 1], er._K, er._KC,
                 2 if n > 2048 else 20)
        if (n, B) == (5, 8192):
            for cols in sc.STREAM_COLS:
                exp_case("random n %d B %d, streamed %d" % (n, B, cols), Xrd, IJ[:, 0],
                         IJ[:, 1], er._K, er._KC, 20, ("streamed", cols))
        del er, Xrd
    # the engine's dispatch: two chunks, the last of 808 pairs
    IJ = _k8_pairs(np, len(X), 9000, 9)
    before = sc.K8.mode_launches["exp"]
    got, m = _no_sync(torch, lambda: eng.dispatch(X, X, IJ))
    launched = sc.K8.mode_launches["exp"] - before
    I, J = (torch.as_tensor(IJ[:, k], device=dev) for k in (0, 1))
    want = torch.cat([w.sinkhorn_exp_chunk_plain(Xd, Xd, I[s:s + 8192], J[s:s + 8192], eng._K,
                                                 eng._KC, 300) for s in (0, 8192)])
    row = _k8_compare(torch, got, want)
    row.update(kernel="K8a", case="dispatch of 9,000 (8,192 + 808)", n_iter=300,
               launches=launched, plan="two launches", model_equal=True)
    row["ok"] = (m == 9000 and launched == 2 and row["finite"] and row["zeros_equal"]
                 and row["max_rel"] <= K8A_RTOL)
    rows.append(row)

    Cd = torch.as_tensor(M.astype(np.float32), device=dev)
    eps = float(np.float32(0.02 * M.max()))
    Xu = torch.as_tensor(w.unit_mass(X), device=dev)
    for B in (1, 256, 4096):
        IJ = torch.as_tensor(_k8_pairs(np, len(X), B, B + 1), device=dev)
        A, Bh = Xu[IJ[:, 0]].contiguous(), Xu[IJ[:, 1]].contiguous()
        for n_iter in (1, 2, 200):
            log_case("digits B %d" % B, A, Bh, Cd, eps, n_iter)
    for n, B in ((5, 256), (100, 256), (224, 20), (300, 256), (784, 256), (14401, 2)):
        Xr, Cr = _k8_random(np, n, 60 if n > 2048 else 2000, n + 1)
        Xu = torch.as_tensor(w.unit_mass(Xr), device=dev)
        IJ = torch.as_tensor(_k8_pairs(np, len(Xr), B, n), device=dev)
        log_case("random n %d B %d" % (n, B), Xu[IJ[:, 0]].contiguous(),
                 Xu[IJ[:, 1]].contiguous(), torch.as_tensor(Cr, device=dev),
                 float(np.float32(0.02 * Cr.max())), 1 if n > 2048 else 30)
        del Cr
    torch.cuda.empty_cache()

    for r in rows:
        print("  %s %-34s n_iter %3d %-32s: max rel %.3g, max abs %.3g, bit-equal %.4f, "
              "model bit-equal %s, %d launch(es)%s" % (
                  r["kernel"], r["case"], r["n_iter"], r["plan"], r["max_rel"],
                  r["max_abs_err"], r["bit_equal_share"], r.get("model_equal", "-"),
                  r["launches"], "" if r["ok"] else "  <-- FAILED"), flush=True)
    bad = [r["kernel"] + " " + r["case"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit("K8 disagrees with its plain version or model: %s" % bad)
    return len(rows), max(r["max_abs_err"] for r in rows), rows


def _k8_timing(torch, np):
    """Phase 5's K8 rows: K8a on a full 8,192-pair chunk of the digits and
    on a 1,797-pair anchor column at n_iter 300 (the resident plan, and
    the streamed one forced), and at large n (``K8A_LARGE``: 300 and 784
    bins on 8,192 pairs at n_iter 20, 2,100 and 7,200 on 64 at n_iter 2,
    random histograms and costs); K8b on a 4,096-pair chunk at n_iter
    200 and at large n (``K8B_LARGE``: 300 and 784 bins on 8,192 pairs at
    n_iter 20, 14,401 on 2 at n_iter 1; ``_k8b_row``): ms by CUDA events
    beside the bound (K8a's FMA at
    ``FP64_FMA_PER_S``, K8b's expf at ``EXPF_PER_S``, or the bytes at
    ``HBM_BYTES_PER_S`` if larger) and its share, and the plain version's
    ms.  No one PyTorch call computes the loop; for K8a ``library_ms`` is
    the plain version's float64 ``torch.mm`` (cuBLAS) alone, one product
    of the same shapes timed and counted 2 n_iter + 2 times."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    dev = torch.device("cuda")
    X, _ = digit_images()
    M = grid_cost_matrix()
    eng = w.SinkhornExpEngine(M, device="cuda")
    Xd = eng._table(X)
    n, n_iter = Xd.shape[1], eng.n_iter
    IJ = torch.as_tensor(np.random.default_rng(5).integers(0, len(X), size=(8192, 2)),
                         device=dev)
    shapes = {"K8a chunk": (Xd, IJ[:, 0], IJ[:, 1], eng, n_iter),
              "K8a column": (Xd, torch.tensor(1126, device=dev).expand(len(X)),
                             torch.arange(len(X), device=dev), eng, n_iter)}
    rng = np.random.default_rng(6)
    for nr, B, it in K8A_LARGE:
        Xr, Cr = _k8_random(np, nr, 200, nr)
        er = w.SinkhornExpEngine(Cr, device="cuda")
        IJr = torch.as_tensor(rng.integers(0, len(Xr), size=(B, 2)), device=dev)
        shapes["K8a n %d B %d" % (nr, B)] = (er._table(Xr), IJr[:, 0], IJr[:, 1], er, it)
    rows = {}
    for name, (Xs, I, J, e, it) in shapes.items():
        B, nb = int(I.shape[0]), int(Xs.shape[1])
        args = (Xs, Xs, I, J, e._K, e._KC, it)
        plan = sc.exp_plan(B, nb)
        fma = B * (2 * it + 2) * nb * nb
        ops_ms = fma / FP64_FMA_PER_S * 1e3
        # two histogram rows, two ids and a cost a pair; K and KC once
        bytes_ms = (B * (2 * nb * 4 + 2 * 8 + 4) + 2 * nb * nb * 8) / HBM_BYTES_PER_S * 1e3
        V = torch.rand((B, nb), dtype=torch.float64, device=dev)
        rows[name] = {
            "pairs": B, "n": nb, "n_iter": it, "plan": "%s %d x %d" % (
                plan["path"], plan["P"], plan["cols"]),
            "launches_per_call": sc.exp_launches(plan, it),
            "ms": _time(torch, lambda: w.sinkhorn_exp_chunk(*args), 10 if B > 64 else 3),
            "plain_ms": _time(torch, lambda: w.sinkhorn_exp_chunk_plain(*args), 2),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": (2 * it + 2) * _time(torch, lambda: torch.mm(V, e._K), 5),
            **_k8_compare(torch, w.sinkhorn_exp_chunk(*args), w.sinkhorn_exp_chunk_plain(*args))}
        if plan["path"] == "resident":
            rows[name]["streamed_ms"] = _time(torch, lambda p=sc.exp_plan(B, nb, "streamed"):
                                              sc.sinkhorn_exp_cuda(*args, w.TINY, _plan=p), 3)
        del V
    leng = w.SinkhornEngine(M, device="cuda")
    Xu = torch.as_tensor(w.unit_mass(X), device=dev)
    A, Bh = Xu[IJ[:4096, 0]].contiguous(), Xu[IJ[:4096, 1]].contiguous()
    Cd = torch.as_tensor(leng.C, device=dev)
    rows["K8b chunk"] = _k8b_row(torch, (A, Bh, Cd, leng.eps, leng.n_iter), 5, 1)
    del A, Bh, shapes, args, e
    torch.cuda.empty_cache()  # the plain version at 784 bins takes ~57 GiB
    for nr, B, it in K8B_LARGE:
        Xr, Cr = _k8_random(np, nr, 40, nr)  # rows 0-15 are the zero and one-bin rows
        Xu = torch.as_tensor(w.unit_mass(Xr), device=dev)
        IJr = rng.integers(16, len(Xr), size=(B, 2))
        args = (Xu[IJr[:, 0]].contiguous(), Xu[IJr[:, 1]].contiguous(),
                torch.as_tensor(Cr, device=dev), float(np.float32(0.02 * Cr.max())), it)
        rows["K8b n %d B %d" % (nr, B)] = _k8b_row(torch, args, 3, 1)
        del Xu, args
        torch.cuda.empty_cache()
    for name, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("  %-18s %5d pairs, n %4d, n_iter %3d, %-19s %9.4f ms | bound %.4f ms (%s), "
              "%.1f %% of it | plain %.3f ms | %s%s| max rel %.3g" % (
                  name, row["pairs"], row["n"], row["n_iter"], row["plan"], row["ms"],
                  row["bound_ms"], row["bound_by"], 100 * row["bound_share"], row["plain_ms"],
                  "library: none " if row.get("library_ms") is None else
                  "its float64 torch.mm %.3f ms " % row["library_ms"],
                  "| streamed forced %.4f ms " % row["streamed_ms"] if "streamed_ms" in row
                  else "", row["max_rel"]), flush=True)
        if "bound_ms_fp32" in row:
            print("  %-18s %d launch(es) a call; FP32-pipe bound %.4f ms (%.1f %% of it)%s"
                  % ("", row["launches_per_call"], row["bound_ms_fp32"],
                     100 * row["bound_ms_fp32"] / row["ms"],
                     "; C over the sweeps %.4f ms" % row["bytes_ms_sweeps"]
                     if "bytes_ms_sweeps" in row else ""), flush=True)
        tol = K8B_RTOL if name.startswith("K8b") else K8A_RTOL
        if row["max_rel"] > tol or not row["finite"]:
            raise SystemExit("%s disagrees with its plain version" % name)
    return rows


def _k12_timing(torch, np):
    """Phase 5's K12 rows (``K12_BATCHES``): the exact EMD of 120,914 near
    pairs of the digits-5620 stand-in (each image with its nearest by
    pixel distance, as a fit's certify pairs) and of 8,980 pairs of the
    digits (every 4th against its 20 nearest of the rest, a query call's):
    K12's ms by CUDA events, the engine's (ids up, K12, distances down)
    and the host solver's (``native.emd_batch`` on this machine's cores)
    by the host clock, the values bit-equal.  On 200 pairs drawn from the
    batch, K12 against its plain version (``emd_simplex_plain``'s solve):
    bit-equal, both timed there (``sample_ms``, ``plain_ms``).  The
    bound: 2 FP64 operations (DADD, DSETP) for each reduced cost priced,
    counted by the plain version on those pairs and scaled to the batch,
    at ``FP64_OPS_PER_S``."""
    from annchor_tpu_torch import native
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix, make_digits_large
    from annchor_tpu_torch.metrics import _EMDEngine
    from annchor_tpu_torch.ops import emd_cuda

    dev = torch.device("cuda")
    M = grid_cost_matrix()
    order = emd_cuda.cell_order(M)
    big, _ = make_digits_large()
    small, _ = digit_images()
    rows = {}
    for (name, P), (X, Q, k) in zip(K12_BATCHES.items(), ((big, big, 22), (small, small[::4], 20))):
        Xd = torch.as_tensor(X, device=dev)
        d2 = torch.cdist(torch.as_tensor(Q, device=dev), Xd)
        if Q is X:
            d2.fill_diagonal_(float("inf"))
        near = torch.topk(d2, k, largest=False).indices.cpu().numpy()
        IJ = np.stack([np.repeat(np.arange(len(Q)), k), near.ravel()], axis=1)[:P]
        IJ = IJ[:, ::-1].copy() if Q is not X else IJ  # index rows first
        eng = _EMDEngine(M, device=dev)
        eng(X, Q, IJ[:8])  # builds K12, tables up
        t0 = time.perf_counter()
        got = eng(X, Q, IJ)
        engine_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = native.emd_batch(X, Q, M, IJ[:, 0], IJ[:, 1])
        host_ms = (time.perf_counter() - t0) * 1e3
        Qd = eng._table(Q)
        args = (eng._table(X), Qd, torch.as_tensor(IJ[:, 0].copy(), device=dev),
                torch.as_tensor(IJ[:, 1].copy(), device=dev), *eng._card)
        before = emd_cuda.K12.launches
        emd_cuda.emd_simplex_cuda(*args)
        launches = emd_cuda.K12.launches - before
        ms = _time(torch, lambda: emd_cuda.emd_simplex_cuda(*args), 5)
        warp = emd_cuda._Warp(M, order)
        sample = np.random.default_rng(9).choice(P, 200, replace=False)
        part = (args[0], Qd, *(torch.as_tensor(IJ[sample, c].copy(), device=dev)
                               for c in (0, 1)), *eng._card)
        on_sample = emd_cuda.emd_simplex_cuda(*part).cpu().numpy()
        sample_ms = _time(torch, lambda: emd_cuda.emd_simplex_cuda(*part), 5)
        plain = np.empty(sample.size)
        priced = pivots = 0
        t0 = time.perf_counter()
        for k, (i, j) in enumerate(IJ[sample]):
            plain[k] = warp.solve(X[i], Q[j])
            priced += warp.priced
            pivots += warp.pivots
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound_ms = 2 * priced * P / 200 / FP64_OPS_PER_S * 1e3
        rows[name] = {"pairs": P, "ms": ms, "engine_ms": engine_ms, "host_ms": host_ms,
                      "launches_per_call": launches, "bound_ms": bound_ms,
                      "bound_by": "operations", "bound_share": bound_ms / ms,
                      "pivots_per_pair": pivots / 200, "priced_per_pair": priced / 200,
                      "bit_equal": got.tobytes() == want.tobytes(),
                      "sample_pairs": int(sample.size), "sample_ms": sample_ms,
                      "plain_ms": plain_ms,
                      "plain_bit_equal": plain.tobytes() == on_sample.tobytes()}
        print("  %-18s %6d pairs, %d launch: %9.4f ms | engine %.3f ms | host solver %.1f ms "
              "(%.1fx) | bound %.4f ms (FP64 pricing, %.1f %% of it; %.1f pivots, %.0f "
              "reduced costs a pair) | bit-equal %s | on %d of its pairs %.4f ms, plain "
              "version %.1f ms, bit-equal %s" % (
                  name, P, launches, ms, engine_ms, host_ms, host_ms / ms, bound_ms,
                  100 * bound_ms / ms, pivots / 200, priced / 200, rows[name]["bit_equal"],
                  sample.size, sample_ms, plain_ms, rows[name]["plain_bit_equal"]),
              flush=True)
        if not rows[name]["bit_equal"]:
            bad = np.flatnonzero(got != want)
            raise SystemExit("K12 differs from the host solver on %d of %d pairs, first %s: "
                             "%r against %r" % (bad.size, P, IJ[bad[0]].tolist(),
                                                got[bad[0]], want[bad[0]]))
        if not rows[name]["plain_bit_equal"]:
            bad = np.flatnonzero(plain != on_sample)
            raise SystemExit("K12 differs from its plain version on %d of %d pairs, first %s"
                             % (bad.size, sample.size, IJ[sample[bad[0]]].tolist()))
    return rows


def _k8b_row(torch, args, reps, plain_reps):
    """K8b on (A, B, C, eps, n_iter) through its dispatch: ms by CUDA events
    beside its plain version's, the bound (the larger of its (2 n_iter + 1)
    n^2 expf a pair at ``EXPF_PER_S`` and its inputs and output at
    ``HBM_BYTES_PER_S``), the FP32 pipe's bound of the same elements
    (``K8B_FP32_PER_ELEM``), and, streamed, C's bytes over the kernel's
    sweeps (two a half step, one for the cost) at ``HBM_BYTES_PER_S``;
    the plan, its launches and the comparison with the plain version."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    A, Bh, C, eps, n_iter = args
    B, n = (int(s) for s in A.shape)
    plan = sc.log_plan(B, n)
    elems = B * (2 * n_iter + 1) * n * n
    ops_ms = elems / EXPF_PER_S * 1e3
    bytes_ms = (B * (2 * n * 4 + 4) + n * n * 4) / HBM_BYTES_PER_S * 1e3
    row = {"pairs": B, "n": n, "n_iter": n_iter, "plan": _log_plan_name(plan),
           "launches_per_call": sc.log_launches(plan, n_iter),
           "ms": _time(torch, lambda: w.sinkhorn_batch(*args), reps),
           "plain_ms": _time(torch, lambda: w.sinkhorn_batch_plain(*args), plain_reps),
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_ms_fp32": elems * K8B_FP32_PER_ELEM / FP32_PER_S * 1e3,
           "library_ms": None,
           **_k8_compare(torch, w.sinkhorn_batch(*args), w.sinkhorn_batch_plain(*args))}
    if plan["path"] == "streamed":
        row["bytes_ms_sweeps"] = (4 * n_iter + 1) * n * n * 4 / HBM_BYTES_PER_S * 1e3
    return row


def _time(torch, fn, reps):
    """Mean ms per call, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _k1_bound(torch, enc, I, J):
    """(word steps, bound in ms, what bounds it) of K1 on these pairs:
    the larger of 11 INT32 instructions per word step at the card's INT32
    rate and the inputs read once and the output written once at its
    memory rate."""
    from annchor_tpu_torch.ops.levenshtein_cuda import word_steps

    steps = word_steps(enc.lengths, I, J)
    ops_ms = steps * K1_OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    nbytes = sum(t.numel() * t.element_size()
                 for t in (enc.peq, enc.ids, enc.lengths, I, J)) + 4 * I.shape[0]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return steps, max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _plan(enc, B, mode="auto"):
    """K1's launch plan for B pairs of ``enc``, as the wrapper makes it."""
    from annchor_tpu_torch.ops.levenshtein_cuda import launch_plan

    return launch_plan(B, enc.wbulk, enc.wmax, enc.alphabet, mode)


def _device_profile(torch, fn, scope=None):
    """Run ``fn`` once under torch.profiler.  Returns a dict: ``wall_s``;
    ``device_ms`` and ``kernels`` in all; ``k1_device_ms`` and
    ``k1_kernels`` (K1's launches), the same for K10, K4, K9a, K8a and
    K8b (``k10_``, ``k4_``, ``k9a_``, ``k8a_``, ``k8b_``); for the ``record_function`` ranges
    named ``scope``, the ``scope_device_ms`` and ``scope_kernels`` of the
    kernels that run inside their mirrors on the card's timeline and
    those mirrors' ``scope_span_ms`` (idle gaps included; a mirror is
    counted as the span, not as a kernel); ``top``, the five kernels that
    take the most time [(name, ms, count)].  Device times sum the
    kernels' own spans.  The profiler's raw events are read directly:
    turning them into its FunctionEvent trees (``prof.events()``) takes
    minutes at the digits-5620 hybrid's ~670,000 kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    starts, durs, spans, by_name = [], [], [], {}
    # kernel name fragments of the hand-written kernels
    tags = {"k1": "k1_", "k10": "k10_", "k4": "k4_tropical", "k9a": "k9a_band",
            "k8a": "k8a_", "k8b": "k8b_"}
    own = {tag: [0.0, 0] for tag in tags}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        if name == scope:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            continue
        us = e.duration_ns() / 1e3
        starts.append(e.start_ns())
        durs.append(us)
        for tag, frag in tags.items():
            if frag in name:
                own[tag][0] += us
                own[tag][1] += 1
        row = by_name.setdefault(name[:60], [0.0, 0])
        row[0] += us / 1e3
        row[1] += 1
    starts = np.asarray(starts, dtype=np.int64)
    durs = np.asarray(durs, dtype=np.float64)
    spans = np.asarray(sorted(spans), dtype=np.int64).reshape(-1, 2)
    inside = np.zeros(starts.shape[0], dtype=bool)
    if spans.shape[0]:
        at = np.searchsorted(spans[:, 0], starts, side="right") - 1
        inside = (at >= 0) & (starts < spans[np.maximum(at, 0), 1])
    top = sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda r: -r[1])[:5]
    out = {"wall_s": wall, "device_ms": float(durs.sum()) / 1e3, "kernels": int(durs.size)}
    for tag, (us, n) in own.items():
        out.update({tag + "_device_ms": us / 1e3, tag + "_kernels": n})
    return {**out,
            "scope_device_ms": float(durs[inside].sum()) / 1e3,
            "scope_kernels": int(inside.sum()),
            "scope_span_ms": float((spans[:, 1] - spans[:, 0]).sum()) / 1e6, "top": top}


def _sinkhorn_fit_profile(torch):
    """Phase 11(c)'s profiled fit, run by 11(c) in a fresh process: the
    ``wasserstein_sinkhorn`` fit of 300 digits once to warm up, then once
    more under ``_device_profile`` with K8's counts set to 0 just before
    it.  Returns the profile's wall, device ms and kernels, K8b's device
    ms and kernels, the K8b launches counted and the fit's evals."""
    import annchor_tpu_torch as att
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops.sinkhorn_cuda import K8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Xd, _ = digit_images()
    M = grid_cost_matrix()

    def make():
        return att.Annchor(Xd[:300], "wasserstein_sinkhorn", func_kwargs={"cost_matrix": M},
                           n_anchors=15, n_neighbors=10, n_samples=2000, p_work=0.3,
                           random_seed=42, device="cuda")

    make().fit()
    ann = make()
    K8.reset_counts()
    prof = _device_profile(torch, ann.fit)
    out = {k: prof[k] for k in ("wall_s", "device_ms", "kernels", "k8b_device_ms",
                                "k8b_kernels")}
    out.update(k8b_launches=K8.mode_launches["log"], evals=int(ann.evals))
    return out


def _kernel_ms(torch, enc, I, J, mode, reps):
    """Kernel-only time: CUDA events around bare launches of one plan,
    the output allocated once."""
    from annchor_tpu_torch.ops.levenshtein_cuda import launch

    plans = _plan(enc, int(I.shape[0]), mode)
    out = torch.empty(I.shape[0], dtype=torch.int32, device="cuda")
    return _time(torch, lambda: launch(plans, enc.peq, enc.ids, enc.lengths, I, J, out), reps)


def _timings(torch, np, X, IJs, big_X):
    """K1 at the main path's batch shapes: through its wrapper (as the
    fit calls it), the bare launch of the wrapper's plan and of each
    forced mode, the bound, the plain version and the time before the
    redesign."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import (
        MyersEncoding,
        myers_maxmin,
        myers_pairs,
        myers_pairs_plain,
    )

    enc = MyersEncoding.from_codes(*encode_strings(list(X)), "cuda")
    big = MyersEncoding.from_codes(*encode_strings(big_X), "cuda")
    rng = np.random.default_rng(2)
    skew = MyersEncoding.from_codes(
        *encode_strings(_skewed(X, np.random.default_rng(5))), "cuda")
    n = len(X)
    ij = torch.as_tensor(IJs.astype(np.int64), device="cuda")
    tri = torch.triu_indices(n, n, 1, device="cuda")
    stri = torch.triu_indices(n + 1, n + 1, 1, device="cuda")
    shapes = {
        "anchor column": (enc, torch.tensor(1126, device="cuda").expand(n),
                          torch.arange(n, device="cuda"), 50, 3),
        "sample batch": (enc, *ij[torch.as_tensor(rng.choice(len(IJs), 5000,
                                                             replace=False))].T, 50, 2),
        "refine batch": (enc, *ij[torch.as_tensor(rng.choice(len(IJs), REFINE_BATCH,
                                                             replace=False))].T, 20, 1),
        "BruteForce": (enc, tri[0], tri[1], 5, 1),
        "100k column": (big, torch.tensor(0, device="cuda").expand(len(big_X)),
                        torch.arange(len(big_X), device="cuda"), 20, 1),
        # strings-1600 and one 2,100-character string; its BruteForce's
        # plain version (every chunk runs 2,100 characters) is not timed
        "skewed column": (skew, torch.tensor(1126, device="cuda").expand(n + 1),
                          torch.arange(n + 1, device="cuda"), 50, 1),
        "skewed BruteForce": (skew, stri[0], stri[1], 5, 0),
    }
    rows = {}
    for name, (e, I, J, reps, plain_reps) in shapes.items():
        if I.stride(0) != 0:
            I, J = I.contiguous(), J.contiguous()
        B = int(I.shape[0])
        steps, bound_ms, bound_by = _k1_bound(torch, e, I, J)
        row = {
            "pairs": B, "wbulk": e.wbulk, "wmax": e.wmax,
            "mode": _modes(_plan(e, B)),
            "ms": _time(torch, lambda: myers_pairs(e, I, J), reps),
            "kernel_ms": _kernel_ms(torch, e, I, J, "auto", reps),
            "thread_ms": _kernel_ms(torch, e, I, J, "thread", reps),
            "group_ms": _kernel_ms(torch, e, I, J, "group", reps),
            "word_steps": steps, "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": (_time(torch, lambda: myers_pairs_plain(e, I, J), plain_reps)
                         if plain_reps else None),
            "before_ms": BEFORE_MS.get(name),
        }
        row["bound_share"] = bound_ms / row["kernel_ms"]
        rows[name] = row
        print("  %-17s %9d pairs W %2d/%2d %-18s wrapper %8.4f ms | kernel %8.4f ms (thread "
              "%8.4f, group %8.4f) | %d word steps, bound %.4f ms (%s), %.1f %% of it | "
              "plain %s ms | before %s ms" % (
                  name, B, e.wbulk, e.wmax, row["mode"], row["ms"], row["kernel_ms"],
                  row["thread_ms"], row["group_ms"], steps, bound_ms, bound_by,
                  100 * row["bound_share"],
                  "not timed" if row["plain_ms"] is None else "%.3f" % row["plain_ms"],
                  "not measured" if row["before_ms"] is None else "%.3f" % row["before_ms"]),
              flush=True)
        if row["before_ms"] is not None and row["ms"] > row["before_ms"]:
            print("    slower through the wrapper than before (%.3f ms)" % row["before_ms"],
                  flush=True)
    # get_anchors of the 100k fit: 96 columns of the max-min loop
    prof = _device_profile(torch, lambda: myers_maxmin(big, 96, 0))
    rows["100k anchors"] = prof
    print("  100k max-min anchors (96 columns, profiled): K1 %.3f ms in %d kernels of "
          "%.3f ms device time, %.3f s wall" % (prof["k1_device_ms"], prof["k1_kernels"],
                                                prof["device_ms"], prof["wall_s"]), flush=True)
    rows["crossover"] = _crossover(torch, np, enc, big, rng)
    return rows


def _crossover(torch, np, enc, big, rng):
    """Kernel-only ms of thread mode and of group mode against the batch
    size: the measurement behind the wrapper's dispatch rule."""
    rows = []
    for label, e, sizes in (
        ("strings-1600", enc, (1_600, 5_000, 20_000, 30_000, 40_000, 58_707, 131_072,
                               1_279_200)),
        # 9,474,796: a select_refine batch of the 100k fit
        ("strings-100k", big, (25_000, 50_000, 100_000, 1_048_576, 9_474_796)),
    ):
        n = e.n
        for B in sizes:
            I = torch.as_tensor(rng.integers(0, n, size=B), device="cuda")
            J = torch.as_tensor(rng.integers(0, n, size=B), device="cuda")
            reps = 20 if B <= 131_072 else 3
            grp = _plan(e, B, "group")[0]
            row = {"set": label, "pairs": B, "wbulk": e.wbulk, "wmax": e.wmax,
                   "auto": _modes(_plan(e, B)),
                   "thread_ms": _kernel_ms(torch, e, I, J, "thread", reps),
                   "group_ms": _kernel_ms(torch, e, I, J, "group", reps),
                   "group_layout": "%dx%d" % (grp.g, grp.wpl)}
            rows.append(row)
            print("  crossover %-12s %9d pairs (auto: %-6s) thread %9.4f ms, group %s "
                  "%9.4f ms" % (label, B, row["auto"], row["thread_ms"],
                                row["group_layout"], row["group_ms"]), flush=True)
    return rows


def _vector_engines(torch, np, att, X):
    """Phase 6 engine check: ``batch_dev`` on the card against a float64
    numpy oracle on 20,000 sampled pairs, and ``fused_maxmin``'s anchors
    against the same call on the CPU.  The oracle reads the float32 copy
    of X the engine computes on, so only the engine's float32 arithmetic
    counts: euclidean and sqeuclidean within 1e-6 of the distance (about
    8 ulps: a 64-term float32 sum), cosine within 2e-6 absolute (its
    1 - num/den cancels)."""
    rng = np.random.default_rng(6)
    n = X.shape[0]
    I = rng.integers(0, n, size=20_000)
    J = rng.integers(0, n, size=20_000)
    X32 = X.astype(np.float32).astype(np.float64)
    a, b = X32[I], X32[J]
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    oracle = {
        "euclidean": np.sqrt(((a - b) ** 2).sum(axis=1)),
        "sqeuclidean": ((a - b) ** 2).sum(axis=1),
        "cosine": 1.0 - (a * b).sum(axis=1) / np.maximum(den, 1e-30),
    }
    rows = {}
    for name, want in oracle.items():
        eng = att.get_function_from_input(name, device="cuda").batch
        got = eng.batch_dev(
            X, torch.as_tensor(I, device="cuda"), torch.as_tensor(J, device="cuda")
        )
        torch.cuda.synchronize()
        got = got.double().cpu().numpy()
        err = np.abs(got - want)
        tol = 2e-6 if name == "cosine" else 1e-6 * np.abs(want)
        A_card, _ = eng.fused_maxmin(X, 20, 0)
        A_cpu, _ = att.get_function_from_input(name, device="cpu").batch.fused_maxmin(X, 20, 0)
        rows[name] = {"max_abs_err": float(err.max()), "anchors_equal": bool(
            np.array_equal(A_card, A_cpu))}
        print("  %-12s batch_dev vs float64 oracle: max|diff| %.3g; fused_maxmin "
              "anchors card == CPU: %s" % (name, err.max(), rows[name]["anchors_equal"]),
              flush=True)
        if not (err <= tol).all():
            raise SystemExit("%s engine outside its tolerance on the card" % name)
        if not rows[name]["anchors_equal"]:
            raise SystemExit("%s fused_maxmin anchors differ between card and CPU" % name)
    return rows


def _timed_fit(torch, att, X, func, **kw):
    """One fit on the card with its stage table; returns (fit, seconds)."""
    ann = att.Annchor(X, func, device="cuda", verbose=True, **kw)
    t0 = time.perf_counter()
    ann.fit()
    torch.cuda.synchronize()
    return ann, time.perf_counter() - t0


def _bruteforce_graph(att, X, func):
    bf = att.BruteForce(X, func, device="cuda")
    bf.fit()
    return bf.neighbor_graph


def _recall(np, ngi, rows, R, k):
    """Id recall and distance-multiset recall of the graph's k-1
    neighbours over exact rows R[t] = d(rows[t], .): a different but
    equidistant neighbour counts as a distance hit (the reference's own
    error semantics, ``compare_neighbor_graphs``)."""
    from collections import Counter

    hits = d_hits = total = 0
    for t, r in enumerate(rows):
        d = R[t].astype(np.float64)
        d[r] = np.inf
        exact = set(np.argsort(d, kind="stable")[: k - 1].tolist())
        got = set(ngi[r, 1:k].tolist())
        hits += len(exact & got)
        total += k - 1
        diff = Counter(np.sort(d[sorted(exact)]).tolist()) - Counter(
            np.sort(d[sorted(got)]).tolist()
        )
        d_hits += (k - 1) - sum(diff.values())
    return hits / total, d_hits / total


def _scale_path(torch, np, att, K1, report, big_X, X, y5, gt5):
    """Phase 9: the scale path on the card, with K1 held against its
    plain version on each corpus first.  ``big_X`` is the 100k corpus,
    ``X`` the 5,000 strings, ``y5`` their cluster ids and ``gt5`` their
    exact graph.  Returns (K1's launches per mode in the fits of (a) and
    (b), max |K1 - plain|, (the 5,000 strings, their cluster ids, their
    fit), the 100k fit)."""
    from annchor_tpu_torch.ops.band_linf_cuda import K9A
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

    rng = np.random.default_rng(9)
    worst = _k1_against_plain(torch, np, "strings-5000", X, 20_000, rng)
    K1.reset_counts()
    K9A.reset_counts()
    ann, report["scale5k_fit_s"] = _timed_fit(
        torch, att, X, "levenshtein", n_neighbors=15, p_work=0.05, random_seed=42,
        uniforms=jax_threefry_uniforms)
    launches = K1.launches
    modes = dict(K1.mode_launches)
    k9a5 = report["scale5k_k9a_modes"] = dict(K9A.mode_launches)
    errors = att.compare_neighbor_graphs(ann.neighbor_graph, gt5, 15)
    report.update(scale5k_evals=int(ann.evals), scale5k_errors=int(errors),
                  scale5k_m=int(ann._ij_dev[2]), scale5k_k1_launches=launches)
    print("  (a) 5,000 strings: %.3f s, m %d, %d evals (JAX package: %d), %d errors "
          "(JAX package: %d), K1 launches %d, K9a launches %s" % (
              report["scale5k_fit_s"], ann._ij_dev[2], ann.evals, SCALE5K_EVALS,
              errors, SCALE5K_ERRORS, launches, k9a5), flush=True)
    if ann._dev is None or not ann._dev.sparse or launches == 0:
        raise SystemExit("the 5,000-string fit did not run the sparse path on K1")
    if ann.evals != SCALE5K_EVALS or errors > SCALE5K_ERRORS:
        raise SystemExit("the 5,000-string fit differs from the JAX package's figures")
    _rms_build(torch, np, att, report, X, gt5, ann)

    X5 = X
    X = big_X
    lengths = [len(x) for x in X]
    worst = max(worst, _k1_against_plain(torch, np, "strings-100k", X, 20_000, rng))
    rows = np.sort(np.random.default_rng(0).choice(len(X), SCALE100K_ROWS, replace=False))
    t0 = time.perf_counter()
    R = att.exact_rows(X, "levenshtein", rows=rows, device="cuda")
    report["scale100k_rows_s"] = time.perf_counter() - t0
    print("  (b) %d strings of %d-%d characters (%.1f s); %d exact rows by exact_rows "
          "(K1) in %.3f s (the hand-written oracle before: %s s)" % (
              len(X), min(lengths), max(lengths), report["scale100k_data_s"], len(rows),
              report["scale100k_rows_s"], " / ".join(map(str, ORACLE_BEFORE_S["100k rows"]))),
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    K1.reset_counts()
    K9A.reset_counts()
    with _capture_bands() as bands:
        big, wall = _timed_fit(torch, att, X, "levenshtein", n_neighbors=15,
                               p_work=SCALE100K_P_WORK, random_seed=42)
    big_launches = K1.launches
    big_modes = dict(K1.mode_launches)
    k9a_big = report["scale100k_k9a_modes"] = dict(K9A.mode_launches)
    peak = torch.cuda.max_memory_allocated()
    budget = int(big.p_work * big.N)
    id_recall, d_recall = _recall(np, big.neighbor_graph[0], rows, R, 15)
    report.update(
        scale100k_fit_s=wall, scale100k_evals=int(big.evals), scale100k_budget=budget,
        scale100k_m=int(big._ij_dev[2]), scale100k_k1_launches=big_launches,
        scale100k_k1_mode_launches=big_modes,
        scale100k_peak_bytes=int(peak), scale100k_id_recall=id_recall,
        scale100k_distance_recall=d_recall,
        scale100k_knobs=[big.n_anchors, big.loc_thresh, big.niters, big.refine_frac],
        scale100k_refine=[{k: v for k, v in st.items()} for st in big._refine_stats],
    )
    print("  (b) default-ctor fit: %.3f s, m %d, %d evals of %d allowed, K1 launches "
          "%d %s, K9a launches %s, peak device memory %.2f GiB, id recall %.4f, distance "
          "recall %.4f (n_anchors %d, loc_thresh %d, niters %d, refine_frac %.2f)" % (
              wall, big._ij_dev[2], big.evals, budget, big_launches, big_modes, k9a_big,
              peak / 2**30, id_recall, d_recall, *report["scale100k_knobs"]), flush=True)
    if not (k9a_big["hist"] and k9a_big["keep"]):
        raise SystemExit("the 100,000-string fit's band build did not launch K9a in both "
                         "modes: %s" % k9a_big)
    if big._dev is None or not big._dev.sparse or big._IJs is not None:
        raise SystemExit("the 100,000-string fit did not keep its pairs on the card")
    if big_launches == 0:
        raise SystemExit("the 100,000-string fit never launched K1")
    if big.evals > budget:
        raise SystemExit("the 100,000-string fit overspent: %d > %d" % (big.evals, budget))
    if d_recall < SCALE100K_MIN_RECALL:
        raise SystemExit("distance recall %.4f < %.2f" % (d_recall, SCALE100K_MIN_RECALL))
    ngi, ngd = big.neighbor_graph
    if ngi.shape != (len(X), 15) or not np.isfinite(ngd).all():
        raise SystemExit("graph of shape %s or with non-finite distances" % (ngi.shape,))
    rounds = [st for st in big._refine_stats if st["stage"].startswith("round")]
    for st in big._refine_stats:
        print("    refine %s" % {k: v for k, v in st.items()}, flush=True)
    if not rounds or not all("screen_dev_s" in st for st in rounds):
        raise SystemExit("the 100,000-string fit's refinement did not screen on the card")
    report["scale100k_slates"] = _slates_check(torch, np, big)
    report["k9a_bands"] = _check_k9a_bands(torch, np, bands)
    del bands
    return {m: modes[m] + big_modes[m] for m in modes}, worst, (X5, y5, ann), big


def _rms_build(torch, np, att, report, X, gt5, lin):
    """Phase 9(c): the strings-5000 fit of (a) under
    ANNCHOR_TPU_BUILD_SCORE=rms, held to the budget and to the JAX test's
    family bound of the linf fit ``lin``'s errors; then one (4096, 2048,
    96) band chunk's score under linf and rms, by CUDA events."""
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
    from annchor_tpu_torch.ops.locality import _band_score

    os.environ["ANNCHOR_TPU_BUILD_SCORE"] = "rms"
    try:
        rms, wall = _timed_fit(torch, att, X, "levenshtein", n_neighbors=15, p_work=0.05,
                               random_seed=42, uniforms=jax_threefry_uniforms)
    finally:
        del os.environ["ANNCHOR_TPU_BUILD_SCORE"]
    err_l = att.compare_neighbor_graphs(gt5, lin.neighbor_graph, 15)
    err_r = att.compare_neighbor_graphs(gt5, rms.neighbor_graph, 15)
    bound = max(2 * err_l, err_l + 20)
    budget = int(rms.p_work * rms.N)
    gen = torch.Generator(device="cuda").manual_seed(0)
    Db = torch.rand((4096, 96), generator=gen, device="cuda") * 400
    Dc = torch.rand((2048, 96), generator=gen, device="cuda") * 400
    chunk = {score: _time(torch, lambda score=score: _band_score(Db, Dc, score), 20)
             for score in ("linf", "rms")}
    report["rms5k"] = {"fit_s": wall, "evals": int(rms.evals), "m": int(rms._ij_dev[2]),
                       "errors": int(err_r), "linf_errors": int(err_l),
                       "band_chunk_ms": chunk}
    print("  (c) strings-5000 under ANNCHOR_TPU_BUILD_SCORE=rms: %.3f s, m %d (linf %d), "
          "%d evals of %d allowed (JAX package: %d), %d errors (JAX package: %d; the linf "
          "fit's %d, bound %d); one (4096, 2048, 96) band chunk's score: linf %.3f ms, "
          "rms %.3f ms" % (wall, rms._ij_dev[2], lin._ij_dev[2], rms.evals, budget,
                           RMS5K_EVALS, err_r, RMS5K_ERRORS, err_l, bound, chunk["linf"],
                           chunk["rms"]), flush=True)
    if rms.evals > budget or err_r > bound or rms._dev is None or not rms._dev.sparse:
        raise SystemExit("the rms build's fit failed its checks")


def _slates_check(torch, np, big):
    """Phase 9(b): one more refinement round of the fitted 100k index
    (its state put back after), in which the device screen's slates are
    held against the host screen's on the same inputs, bit for bit."""
    from annchor_tpu_torch import refine

    seen = {}
    dev_screen = refine._screen_dev

    def both(gi, gd, kth, pool, nx, kk, q, tally=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lq, ubq = dev_screen(gi, gd, kth, pool, nx, kk, q, tally)
        lq_d, ubq_d = lq.cpu().numpy(), ubq.cpu().numpy()
        seen["dev_s"] = time.perf_counter() - t
        t = time.perf_counter()
        lq_h, ubq_h = refine._screen_host(gi.cpu().numpy(), gd.cpu().numpy(), kth.cpu().numpy(),
                                          pool.cpu().numpy(), nx, kk, q)
        seen["host_s"] = time.perf_counter() - t
        seen.update(shape=list(lq_d.shape), pool=int(pool.shape[0]),
                    equal=bool(np.array_equal(lq_d, lq_h)
                               and np.array_equal(ubq_d.view(np.int32), ubq_h.view(np.int32))),
                    admitted=int(np.isfinite(ubq_d).sum()))
        return lq, ubq

    fitted = (big.neighbor_graph, big._ng_exact, big.evals, big._refine_stats)
    refine._screen_dev = both
    try:
        big.refine_neighbor_graph(rounds=1, budget=200_000)
    finally:
        refine._screen_dev = dev_screen
        big.neighbor_graph, big._ng_exact, big.evals, big._refine_stats = fitted
    print("  (b) one refinement round's slates on the fitted index: (%d, %d) over a pool "
          "of %d pairs, %d admitted; device screen %.3f s, host screen %.3f s; bit-equal %s"
          % (*seen["shape"], seen["pool"], seen["admitted"], seen["dev_s"], seen["host_s"],
             seen["equal"]), flush=True)
    if not seen.get("equal"):
        raise SystemExit("the device screen's slates differ from the host screen's")
    return seen


@contextlib.contextmanager
def _encode_clock():
    """Seconds and calls of the metric engine's string encoding while the
    block runs: ``_LevenshteinEngine.build`` (on a card: the code points
    up, then the alphabet, ids and Peq built there), synchronised."""
    import torch

    import annchor_tpu_torch.metrics as tm

    clock = {"encode_s": 0.0, "encodes": 0}
    real = tm._LevenshteinEngine.build

    def build(self, X):
        t0 = time.perf_counter()
        try:
            enc = real(self, X)
            torch.cuda.synchronize()
            return enc
        finally:
            clock["encode_s"] += time.perf_counter() - t0
            clock["encodes"] += 1

    tm._LevenshteinEngine.build = build
    try:
        yield clock
    finally:
        tm._LevenshteinEngine.build = real


def _timed_query(torch, ann, Q, nn, p_work, hold=True):
    """One ``query`` on the card: ((ngi, ngd), wall s, encode clock).
    ``hold=False`` runs it with the engine's encoding hold replaced by a
    null context, so every metric call encodes the database again."""
    import annchor_tpu_torch.query as tq

    real = tq._held_encoding
    if not hold:
        tq._held_encoding = lambda ann: contextlib.nullcontext()
    try:
        with _encode_clock() as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ann.query(Q, nn=nn, p_work=p_work)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        tq._held_encoding = real
    return out, wall, clock


def _query_report(torch, np, K1, ann, Q, R, sources, nn, p_work, label):
    """The timed query with K1's launches and the encode clock, then the
    same query without the encoding hold, which must give the same
    answer.  ``sources[q]``: the database string query q was made from.
    Returns (ngi, ngd, report row, K1 launches per mode)."""
    K1.reset_counts()
    (ngi, ngd), wall, clock = _timed_query(torch, ann, Q, nn, p_work)
    launches, modes = K1.launches, dict(K1.mode_launches)
    (ngi2, ngd2), wall2, clock2 = _timed_query(torch, ann, Q, nn, p_work, hold=False)
    if not (np.array_equal(ngi, ngi2) and np.array_equal(ngd, ngd2)):
        raise SystemExit("%s: the query differs without the encoding hold" % label)
    row = {
        "queries": len(Q), "wall_s": wall, "ms_per_query": 1e3 * wall / len(Q),
        "k1_launches": launches, "k1_mode_launches": modes,
        "distance_recall": query_recall(ngi, R, nn),
        "source_first": float(np.mean(ngi[:, 0] == sources)),
        "encode": clock, "wall_s_no_hold": wall2, "encode_no_hold": clock2,
    }
    enc = clock["encode_s"]
    enc2 = clock2["encode_s"]
    print("  %s: %d queries in %.4f s (%.3f ms/query), K1 launches %d %s, distance recall "
          "%.6f, source first %.4f; encoding %.3f s in %d encodes (%.1f %% of the wall); "
          "without the hold %.4f s, encoding %.3f s in %d encodes (%.1f %%)" % (
              label, len(Q), wall, row["ms_per_query"], launches, modes,
              row["distance_recall"], row["source_first"], enc, clock["encodes"],
              100 * enc / wall, wall2, enc2, clock2["encodes"], 100 * enc2 / wall2),
          flush=True)
    if ngi.shape != (len(Q), nn + 1) or not np.isfinite(ngd).all():
        raise SystemExit("%s: result of shape %s or with non-finite distances"
                         % (label, ngi.shape))
    if launches == 0:
        raise SystemExit("%s never launched K1" % label)
    return ngi, ngd, row, modes


def _serve(torch, np, att, K1, report, X, ref, scale5k, big, big_X, out_dir):
    """Phase 10: the post-fit surface on the card.  (a) query of the
    strings-1600 index, (b) its v1 round trip, (c) the extras on blobs,
    (d) the extras on the 5,000-string scale fit's device state, (e) the
    100k index saved as v2, loaded with its pair list rebuilt, queried
    and refined.  Returns K1's launches per mode over (a), (b), (d), (e),
    each counted from 0."""
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

    serve = report["serve"] = {}
    modes_all = {}

    def add(modes):
        for k, v in modes.items():
            modes_all[k] = modes_all.get(k, 0) + v

    os.makedirs(os.path.join(out_dir, "serve"), exist_ok=True)

    # (a) query of the strings-1600 index (phase 4's JAX-stream fit)
    Q = mutate_strings(X[:1000], 0.05, 7)
    t0 = time.perf_counter()
    R = att.exact_query_rows(X, Q, "levenshtein", device="cuda")
    serve["a_exact_query_rows_s"] = time.perf_counter() - t0
    ref.query(Q, nn=15, p_work=0.2)  # warm-up
    ngi, ngd, serve["a"], modes = _query_report(torch, np, K1, ref, Q, R, np.arange(len(Q)),
                                                15, 0.2, "(a) strings-1600 query")
    add(modes)
    floor = max(0.99, SERVE_QUERY_RECALL - SERVE_QUERY_SLACK)
    if serve["a"]["distance_recall"] < floor:
        raise SystemExit("(a) distance recall %.6f < %.3f (JAX package: %.6f)" % (
            serve["a"]["distance_recall"], floor, SERVE_QUERY_RECALL))
    if serve["a"]["source_first"] < 0.99:
        raise SystemExit("(a) only %.4f of the queries find their source first"
                         % serve["a"]["source_first"])

    # (b) v1 round trip
    path = os.path.join(out_dir, "serve", "strings1600_v1.npz")
    t0 = time.perf_counter()
    ref.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = att.Annchor.load(path, X, "levenshtein", device="cuda")
    load_s = time.perf_counter() - t0
    same_graph = all(np.array_equal(a, b) for a, b in zip(loaded.neighbor_graph,
                                                          ref.neighbor_graph))
    K1.reset_counts()
    li, ld = loaded.query(Q, nn=15, p_work=0.2)
    torch.cuda.synchronize()
    launches, modes = K1.launches, dict(K1.mode_launches)
    add(modes)
    same_query = np.array_equal(li, ngi) and np.array_equal(ld, ngd)
    serve["b"] = {"save_s": save_s, "load_s": load_s, "bytes": os.path.getsize(path),
                  "graph_equal": same_graph, "query_equal": same_query,
                  "k1_launches": launches}
    print("  (b) v1 round trip: save %.3f s, %d bytes, load %.3f s; graph bit-equal %s, "
          "loaded index's query bit-equal %s, K1 launches %d %s" % (
              save_s, serve["b"]["bytes"], load_s, same_graph, same_query, launches,
              modes), flush=True)
    if not (same_graph and same_query and launches):
        raise SystemExit("(b) the loaded strings-1600 index differs")

    # (c) the extras on blobs (no K1: euclidean)
    Xb, yb = make_blobs(1000, 2, 5, 1)
    eb = att.Annchor(Xb, "euclidean", n_anchors=12, n_neighbors=15, p_work=0.4,
                     random_seed=42, device="cuda", uniforms=jax_threefry_uniforms)
    eb.fit()
    fit_evals = eb.evals
    t0 = time.perf_counter()
    egi, egd = eb.get_nearest_enemies(yb, nn=3)
    enemy_s = time.perf_counter() - t0
    enemy_evals = eb.evals - fit_evals
    D = np.linalg.norm(Xb[:, None] - Xb[None], axis=2)
    exact_enemy = np.where(yb[None, :] != yb[:, None], D, np.inf).min(axis=1)
    enemy_acc = float(np.isclose(egd[:, 0], exact_enemy, rtol=1e-6).mean())
    t0 = time.perf_counter()
    ss = eb.annchor_selective_subset(yb)
    subset_s = time.perf_counter() - t0
    ss_acc = float(np.mean(yb[ss[np.argmin(D[:, ss], axis=1)]] == yb))
    t0 = time.perf_counter()
    rss = eb.alpha_rss(yb)
    rss_s = time.perf_counter() - t0
    rss_acc = float(np.mean(yb[rss[np.argmin(D[:, rss], axis=1)]] == yb))
    rng = np.random.default_rng(12)
    ids = rng.choice(len(Xb), 100, replace=False)
    Qb = Xb[ids] + rng.normal(scale=0.02, size=(100, 2))
    t0 = time.perf_counter()
    lgi, lgd = eb.legacy_query(Qb, k=5)
    legacy_s = time.perf_counter() - t0
    DQ = np.linalg.norm(Qb[:, None] - Xb[None], axis=2)
    top5 = np.argsort(DQ, axis=1, kind="stable")[:, :5]
    overlap = float(np.mean([len(set(lgi[i]) & set(top5[i])) / 5 for i in range(100)]))
    serve["c"] = {"fit_evals": fit_evals, "enemy_evals": enemy_evals, "enemy_s": enemy_s,
                  "enemy_accuracy": enemy_acc, "subset": len(ss), "subset_s": subset_s,
                  "subset_accuracy": ss_acc, "rss": len(rss), "rss_s": rss_s,
                  "rss_accuracy": rss_acc, "legacy_overlap": overlap,
                  "legacy_s": legacy_s}
    print("  (c) blobs 1000 x 2: fit %d evals (JAX package: %d); nearest enemies %.3f s, "
          "%d evals (JAX package: %d), first enemy exact for %.4f; selective subset %d "
          "(JAX package: %d) in %.3f s, 1-NN accuracy %.4f; alpha_rss %d in %.3f s, "
          "1-NN accuracy %.4f; legacy_query 100 x k=5 in %.3f s, top-5 overlap %.4f" % (
              fit_evals, SERVE_BLOBS_EVALS, enemy_s, enemy_evals, SERVE_BLOBS_ENEMY_EVALS,
              enemy_acc, len(ss), SERVE_BLOBS_SUBSET, subset_s, ss_acc, len(rss), rss_s,
              rss_acc, legacy_s, overlap), flush=True)
    if fit_evals != SERVE_BLOBS_EVALS:
        raise SystemExit("(c) the blobs fit differs from the JAX package's")
    if not (yb[egi] != yb[:, None]).all() or enemy_acc < 0.97:
        raise SystemExit("(c) nearest enemies wrong")
    if ss_acc < 0.99 or len(ss) != SERVE_BLOBS_SUBSET:
        raise SystemExit("(c) selective subset wrong")
    if rss_acc < 0.97 or overlap < 0.9:
        raise SystemExit("(c) alpha_rss or legacy_query below its floor")

    # (d) the extras on the 5,000-string fit's device state
    X5, y5, s5 = scale5k
    ev0 = s5.evals
    K1.reset_counts()
    t0 = time.perf_counter()
    sgi, sgd = s5.get_nearest_enemies(y5, nn=3)
    sss = s5.annchor_selective_subset(y5)
    torch.cuda.synchronize()
    extras_s = time.perf_counter() - t0
    launches, modes = K1.launches, dict(K1.mode_launches)
    add(modes)
    alive = s5._dev is not None and s5._IJs is None
    rows = np.sort(np.random.default_rng(3).choice(len(X5), 500, replace=False))
    R5 = att.exact_rows(X5, "levenshtein", rows=rows, device="cuda")
    exact5 = np.where(y5[None, :] != y5[rows][:, None], R5, np.inf).min(axis=1)
    acc5 = float(np.mean(sgd[rows, 0] == exact5))
    excess5 = float(np.mean(sgd[rows, 0] - exact5))
    ss_acc5 = float(np.mean(y5[sss[np.argmin(R5[:, sss], axis=1)]] == y5[rows]))
    serve["d"] = {"extras_s": extras_s, "evals": s5.evals - ev0, "m": int(s5._dev.m),
                  "k1_launches": launches, "enemy_exact": acc5, "enemy_excess": excess5,
                  "exact_enemy_mean": float(exact5.mean()), "subset": len(sss),
                  "subset_accuracy_500": ss_acc5, "device_state_alive": alive}
    print("  (d) 5,000 strings, 16 labels, on the sparse device state: enemies + subset "
          "%.3f s, %d evals (JAX package: %d), m now %d, K1 launches %d %s; first enemy "
          "exact for %.4f of 500 rows (JAX package: %.4f), %.4f edits over the exact "
          "nearest enemy (%.2f) on average; subset %d (JAX package: %d; 1-NN accuracy %.4f "
          "on those rows); _dev alive and _IJs None: %s" % (
              extras_s, serve["d"]["evals"], SERVE_5K_ENEMY_EVALS, serve["d"]["m"],
              launches, modes, acc5, SERVE_5K_ENEMY_EXACT, excess5, exact5.mean(),
              len(sss), SERVE_5K_SUBSET, ss_acc5, alive), flush=True)
    if not alive or launches == 0:
        raise SystemExit("(d) the extras left the device state or never launched K1")
    if not (y5[sgi] != y5[:, None]).all() or acc5 < SERVE_5K_ENEMY_EXACT - 0.005:
        raise SystemExit("(d) nearest enemies wrong")

    # (e) the 100k index: v2 save, load with the pair build, query, refine
    path = os.path.join(out_dir, "serve", "strings100k_v2.npz")
    t0 = time.perf_counter()
    big.save(path)
    save_s = time.perf_counter() - t0
    from annchor_tpu_torch.ops.band_linf_cuda import K9A

    K9A.reset_counts()
    t0 = time.perf_counter()
    loaded = att.Annchor.load(path, big_X, "levenshtein", rebuild_pairs=True,
                              device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_k9a = dict(K9A.mode_launches)
    m = int(big._dev.m)
    same_graph = all(np.array_equal(a, b) for a, b in zip(loaded.neighbor_graph,
                                                          big.neighbor_graph))
    same_pairs = loaded._ij_dev[2] == m and all(
        torch.equal(a, b[:m]) for a, b in zip(loaded._ij_dev[:2], (big._dev.ij_i,
                                                                  big._dev.ij_j)))
    print("  (e) v2 save %.3f s, %d bytes; load with rebuild_pairs %.3f s (K9a launches "
          "%s); graph bit-equal %s, pair list equal (m %d) %s" % (
              save_s, os.path.getsize(path), load_s, load_k9a, same_graph, m, same_pairs),
          flush=True)
    if not (same_graph and same_pairs):
        raise SystemExit("(e) the loaded 100k index differs")
    if not (load_k9a["hist"] and load_k9a["keep"]):
        raise SystemExit("(e) the pair rebuild did not launch K9a in both modes")
    rng = np.random.default_rng(11)
    src = rng.choice(len(big_X), 500, replace=False)
    Qe = mutate_strings([big_X[i] for i in src], 0.01, 11)
    t0 = time.perf_counter()
    Re = att.exact_query_rows(big_X, Qe, "levenshtein", device="cuda")
    rows_s = time.perf_counter() - t0
    print("  (e) 500 exact query rows by exact_query_rows (K1) in %.3f s (the hand-written "
          "oracle before: %s s); (a)'s 1,000 in %.3f s" % (
              rows_s, " / ".join(map(str, ORACLE_BEFORE_S["100k query rows"])),
              serve["a_exact_query_rows_s"]), flush=True)
    loaded.query(Qe[:20], nn=15, p_work=SCALE100K_P_WORK)  # warm-up
    _, _, row, modes = _query_report(torch, np, K1, loaded, Qe, Re, src, 15,
                                     SCALE100K_P_WORK, "(e) 100k query")
    add(modes)
    ev0 = loaded.evals
    K1.reset_counts()
    t0 = time.perf_counter()
    loaded.refine_neighbor_graph(rounds=1, budget=200_000)
    refine_s = time.perf_counter() - t0
    spent = loaded.evals - ev0
    hits = sum(s.get("store_hits", 0) for s in loaded._refine_stats)
    serve["e"] = dict(row, save_s=save_s, bytes=os.path.getsize(path), load_s=load_s,
                      load_k9a_modes=load_k9a,
                      exact_rows_s=rows_s, refine_s=refine_s, refine_evals=spent,
                      refine_store_hits=hits, refine_k1_launches=K1.launches,
                      refine=loaded._refine_stats)
    print("  (e) refine_neighbor_graph(rounds=1, budget=200,000) on the loaded index: "
          "%.3f s, %d evals, %d pairs merged from the stored exact values, K1 launches %d"
          % (refine_s, spent, hits, K1.launches), flush=True)
    if row["distance_recall"] < 0.99:
        raise SystemExit("(e) distance recall %.4f < 0.99" % row["distance_recall"])
    if hits < 1 or spent > 200_000:
        raise SystemExit("(e) refine merged nothing from the store or overspent")
    return modes_all


def _slow_metrics(torch, np, att, K1, report, X, gt):
    """Phase 11: the exact oracle on K1, the digits hybrid, the
    Sinkhorn-only fit and graph-sp.  Returns K1's launches per mode in
    (a)'s exact_knn."""
    from scipy.sparse.csgraph import connected_components

    from annchor_tpu_torch import native
    from annchor_tpu_torch.datasets import (
        digit_images,
        graph_adjacency,
        grid_cost_matrix,
        make_graph,
    )
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
    from annchor_tpu_torch.ops.emd_cuda import K12
    from annchor_tpu_torch.ops.sinkhorn_cuda import K8

    out = report["slow_metrics"] = {}

    # (a) exact_knn over strings-1600 on K1, against phase 3's BruteForce
    K1.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = att.exact_knn(X, "levenshtein", k=N_NEIGHBORS, device="cuda")
    wall = time.perf_counter() - t0
    modes = dict(K1.mode_launches)
    gi, gd = gt[0][:, :N_NEIGHBORS], gt[1][:, :N_NEIGHBORS]
    untied = gt[1][:, N_NEIGHBORS - 1] != gt[1][:, N_NEIGHBORS]
    same_d = bool(np.array_equal(dist, gd))
    same_i = bool(np.array_equal(idx[untied], gi[untied]))
    out["a"] = {"exact_knn_s": wall, "k1_launches": K1.launches, "k1_mode_launches": modes,
                "distances_equal": same_d, "indices_equal_untied": same_i,
                "untied_rows": int(untied.sum()),
                "indices_equal_all": bool(np.array_equal(idx, gi)),
                "bruteforce_s": report["bruteforce_s"]}
    print("  (a) exact_knn(strings-1600, k=25): %.3f s (BruteForce %.3f s), K1 launches %d %s; "
          "distances bit-equal %s, indices equal on the %d rows with an untied 25th "
          "distance %s (on every row %s)" % (
              wall, report["bruteforce_s"], K1.launches, modes, same_d, untied.sum(), same_i,
              out["a"]["indices_equal_all"]), flush=True)
    if not (same_d and same_i and K1.launches):
        raise SystemExit("(a) exact_knn differs from BruteForce or never launched K1")

    # (b) the digits-1797 hybrid against the exact EMD graph
    Xd, _ = digit_images()
    M = grid_cost_matrix()
    t0 = time.perf_counter()
    ei, ed = att.exact_knn(Xd, "wasserstein", {"cost_matrix": M}, k=N_NEIGHBORS,
                           device="cpu")
    gt_s = time.perf_counter() - t0
    K12.reset_counts()
    t0 = time.perf_counter()
    ci, cd = att.exact_knn(Xd, "wasserstein", {"cost_matrix": M}, k=N_NEIGHBORS,
                           device="cuda")
    card_s = time.perf_counter() - t0
    card_launches = K12.launches
    card_equal = bool(np.array_equal(ci, ei) and cd.tobytes() == ed.tobytes())
    kw = dict(func_kwargs={"cost_matrix": M, "scout": "sinkhorn"}, n_anchors=25,
              n_neighbors=N_NEIGHBORS, n_samples=5000, p_work=0.16, random_seed=42,
              device="cuda")
    rows = []
    for run in ("timed", "profiled"):
        ann = att.Annchor(Xd, "wasserstein", verbose=run == "timed", **kw)
        emd = {"s": 0.0, "calls": 0, "batches": 0}
        exact_eval = ann._exact_eval

        def timed_exact(f, X_, IJ, exact_eval=exact_eval, emd=emd):
            t = time.perf_counter()
            try:
                return exact_eval(f, X_, IJ)
            finally:
                emd["s"] += time.perf_counter() - t
                emd["calls"] += len(IJ)
                emd["batches"] += len(IJ) > 0

        ann._exact_eval = timed_exact
        K8.reset_counts()
        K12.reset_counts()
        if run == "timed":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ann.fit()
            torch.cuda.synchronize()
            row = {"wall_s": time.perf_counter() - t0}
        else:
            row = _device_profile(torch, ann.fit, "sinkhorn_exp_chunk")
            for name, ms, cnt in row["top"]:
                print("    %-60s %10.3f ms in %6d events" % (name, ms, cnt), flush=True)
        row.update(k8a_launches=K8.mode_launches["exp"], k12_launches=K12.launches,
                   exact_batches=emd["batches"])
        errors = att.compare_neighbor_graphs((ei, ed), ann.neighbor_graph, N_NEIGHBORS)
        ngi, ngd = ann.neighbor_graph
        check = native.emd_batch(Xd, Xd, M, np.repeat(np.arange(len(Xd)), N_NEIGHBORS),
                                 ngi.reshape(-1))
        row.update(evals=int(ann.evals), scout_evals=int(ann.scout_evals),
                   errors=int(errors), exact_emd_s=emd["s"], exact_emd_calls=emd["calls"],
                   max_abs_err_reported=float(np.abs(check - ngd.reshape(-1)).max()),
                   anchors=[int(a) for a in ann.A[:5]])
        rows.append(row)
        print("  (b) digits-1797 hybrid (%s): %.3f s wall, %d exact calls (JAX package on a "
              "CPU: %d), %d scout calls (%d), %d errors (%d; contract < %d), reported "
              "distances within %.3g of the exact EMD, exact EMD %.3f s in %d calls, K8a "
              "launches %d, K12 launches %d for %d exact batches%s" % (
                  run, row["wall_s"], ann.evals, DIGITS_EVALS, ann.scout_evals,
                  DIGITS_SCOUT_EVALS, errors, DIGITS_ERRORS, DIGITS_MAX_ERRORS,
                  row["max_abs_err_reported"], emd["s"], emd["calls"], row["k8a_launches"],
                  row["k12_launches"], row["exact_batches"],
                  "" if run == "timed" else "; device %.3f ms in %d kernels, the Sinkhorn "
                  "scout %.3f ms in %d kernels over a %.3f ms span of the card's timeline, "
                  "K8a %.3f ms in %d kernels"
                  % (row["device_ms"], row["kernels"], row["scope_device_ms"],
                     row["scope_kernels"], row["scope_span_ms"], row["k8a_device_ms"],
                     row["k8a_kernels"])), flush=True)
        if not row["k8a_launches"]:
            raise SystemExit("(b) the digits hybrid never launched K8a")
        if not row["k12_launches"] or row["k12_launches"] != row["exact_batches"]:
            raise SystemExit("(b) the digits hybrid launched K12 %d times for %d exact batches"
                             % (row["k12_launches"], row["exact_batches"]))
        if errors >= DIGITS_MAX_ERRORS or row["max_abs_err_reported"] > 1e-9:
            raise SystemExit("(b) the digits hybrid: %d errors, reported distances off by "
                             "%.3g" % (errors, row["max_abs_err_reported"]))
        if ngi.shape != (len(Xd), N_NEIGHBORS) or not ann._scouting:
            raise SystemExit("(b) the digits hybrid did not run the scout/certify path")
    out["b"] = {"exact_knn_s": gt_s, "exact_knn_card_s": card_s,
                "exact_knn_k12_launches": card_launches, "exact_knn_card_equal": card_equal,
                "emd_solves": len(Xd) ** 2, "fits": rows}
    print("  (b) its exact 25-NN graph by exact_knn: %.3f s for %d EMD solves by the host "
          "solver; on the card %.3f s in %d K12 launches, graph bit-equal %s"
          % (gt_s, len(Xd) ** 2, card_s, card_launches, card_equal), flush=True)
    if not (card_equal and card_launches):
        raise SystemExit("(b) exact_knn on the card differs from the host solver's graph")

    # (c) wasserstein_sinkhorn on 300 digits (tests/test_hybrid.py:123-131)
    X3 = Xd[:300]
    exact10 = att.exact_knn(X3, "wasserstein", {"cost_matrix": M}, k=10, device="cpu")[0]
    K8.reset_counts()
    t0 = time.perf_counter()
    sk = att.Annchor(X3, "wasserstein_sinkhorn", func_kwargs={"cost_matrix": M},
                     n_anchors=15, n_neighbors=10, n_samples=2000, p_work=0.3,
                     random_seed=42, device="cuda")
    sk.fit()
    torch.cuda.synchronize()
    sk_s = time.perf_counter() - t0
    k8b = K8.mode_launches["log"]
    got = sk.neighbor_graph[0][:, :10]
    recall = sum(len(np.intersect1d(exact10[i], got[i])) for i in range(len(X3))) / got.size
    # the same fit under the profiler in a fresh process: K8b's device
    # time, every launch of it recorded.  In this process, after the
    # earlier phases' profiles, the profiler misses the first ~30 kernels
    # of a window (5 of this fit's 19 K8b launches)
    torch.cuda.empty_cache()
    code = ("import json, sys; sys.path.insert(0, %r); import torch, chip_smoke; "
            "print(json.dumps(chip_smoke._sinkhorn_fit_profile(torch)))"
            % os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=600)
    if child.returncode:
        raise SystemExit("(c) the profiled fit failed:\n%s" % child.stderr[-3000:])
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    k8b_prof = prof["k8b_launches"]
    out["c"] = {"fit_s": sk_s, "evals": int(sk.evals), "recall": recall, "k8b_launches": k8b,
                "profiled_wall_s": prof["wall_s"], "device_ms": prof["device_ms"],
                "kernels": prof["kernels"], "k8b_device_ms": prof["k8b_device_ms"],
                "k8b_kernels": prof["k8b_kernels"], "k8b_launches_profiled": k8b_prof}
    print("  (c) wasserstein_sinkhorn on 300 digits: %.3f s, %d evals, neighbour-set recall "
          "%.4f (floor %.2f), K8b launches %d; profiled in a fresh process: %.3f s, device "
          "%.3f ms in %d kernels, K8b %.3f ms in %d kernels of %d launches" % (
              sk_s, sk.evals, recall, SINKHORN_MIN_RECALL, k8b, prof["wall_s"],
              prof["device_ms"], prof["kernels"], prof["k8b_device_ms"], prof["k8b_kernels"],
              k8b_prof), flush=True)
    if recall < SINKHORN_MIN_RECALL or sk.is_metric:
        raise SystemExit("(c) the Sinkhorn-only fit's recall %.4f" % recall)
    if prof["evals"] != sk.evals or not k8b_prof or prof["k8b_kernels"] != k8b_prof:
        raise SystemExit("(c) the profiled fit spent %d evals (the timed one %d); the profiler "
                         "recorded %d K8b kernels of its %d launches"
                         % (prof["evals"], sk.evals, prof["k8b_kernels"], k8b_prof))
    if not k8b:
        raise SystemExit("(c) the Sinkhorn-only fit never launched K8b")

    # (d) graph-sp on the giant component of make_graph()
    edges, weights, y = make_graph()
    A = graph_adjacency(len(y), edges, weights)
    _, labels = connected_components(A, directed=False)
    Xg = np.flatnonzero(labels == np.argmax(np.bincount(labels)))
    gsp = att.GraphShortestPathMetric(A)
    ggt = att.exact_knn(Xg, gsp, k=15, device="cuda")
    t0 = time.perf_counter()
    g = att.Annchor(Xg, gsp, n_anchors=20, n_neighbors=15, p_work=0.15, random_seed=42,
                    uniforms=jax_threefry_uniforms, device="cuda")
    g.fit()
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    g_errors = att.compare_neighbor_graphs(ggt, g.neighbor_graph, 15)
    out["d"] = {"n": int(Xg.shape[0]), "fit_s": g_s, "evals": int(g.evals),
                "errors": int(g_errors)}
    print("  (d) graph-sp on the %d-vertex component: %.3f s, %d evals (JAX package: %d), "
          "%d errors (JAX package: %d)" % (Xg.shape[0], g_s, g.evals, GRAPH_EVALS, g_errors,
                                           GRAPH_ERRORS), flush=True)
    if g.evals != GRAPH_EVALS or g_errors > GRAPH_ERRORS:
        raise SystemExit("(d) the graph-sp fit differs from the JAX package's figures")
    if not np.isfinite(g.neighbor_graph[1]).all():
        raise SystemExit("(d) the graph-sp fit reported non-finite distances")
    return modes


def _digits5620(torch, np, att, report):
    """Phase 12(a) and (b): the digits-5620 scout/certify hybrid on the
    admit-everything build, against the stored exact graph; then the same
    fit with ``max_resident_pairs`` under its admitted total, which must
    switch to the budgeted build."""
    from annchor_tpu_torch import native
    from annchor_tpu_torch.datasets import load_digits_large
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
    from annchor_tpu_torch.ops.emd_cuda import K12
    from annchor_tpu_torch.ops.sinkhorn_cuda import K8

    d = load_digits_large()
    X, M = d["X"], d["cost_matrix"]
    gt = (d["neighbor_graph"][0][:, :N_NEIGHBORS], d["neighbor_graph"][1][:, :N_NEIGHBORS])
    kw = dict(func_kwargs={"cost_matrix": M, "scout": "sinkhorn"}, n_anchors=30,
              n_neighbors=N_NEIGHBORS, p_work=0.1, random_seed=42,
              uniforms=jax_threefry_uniforms, device="cuda", **DIGITS5620_KNOBS)
    pin = DIGITS5620
    out = report["digits5620"] = {"jax_cpu": pin, "fits": []}

    def check(ann, run, row):
        errors = att.compare_neighbor_graphs(gt, ann.neighbor_graph, N_NEIGHBORS)
        ngi, ngd = ann.neighbor_graph
        exact = native.emd_batch(X, X, M, np.repeat(np.arange(len(X)), N_NEIGHBORS),
                                 ngi.reshape(-1))
        row.update(run=run, evals=int(ann.evals), scout_evals=int(ann.scout_evals),
                   errors=int(errors), m=int(ann._ij_dev[2]), locality=ann._locality_info,
                   max_abs_err_reported=float(np.abs(exact - ngd.reshape(-1)).max()))
        out["fits"].append(row)
        print("  (%s) digits-5620 hybrid (%s): %.3f s wall, build %s, m %d of %d admitted, "
              "%d exact calls (JAX package on a CPU: %d), %d scout calls (%d), %d errors "
              "(%d; contract < %d), reported distances within %.3g of the exact EMD, exact "
              "EMD %.3f s in %d calls, K8a launches %d, K12 launches %d for %d exact batches%s"
              % ("b" if run == "switched" else "a", run, row["wall_s"],
                  row["locality"]["build"], row["m"], row["locality"]["admitted"],
                  ann.evals, pin["evals"], ann.scout_evals, pin["scout_evals"], errors,
                  pin["errors"], DIGITS_MAX_ERRORS, row["max_abs_err_reported"],
                  row["exact_emd_s"], row["exact_emd_calls"], row["k8a_launches"],
                  row["k12_launches"], row["exact_batches"],
                  "" if "device_ms" not in row else "; device %.3f ms in %d kernels, the "
                  "Sinkhorn scout %.3f ms in %d kernels over a %.3f ms span of the card's "
                  "timeline, K8a %.3f ms in %d kernels" % (
                      row["device_ms"], row["kernels"], row["scope_device_ms"],
                      row["scope_kernels"], row["scope_span_ms"], row["k8a_device_ms"],
                      row["k8a_kernels"])), flush=True)
        if row["max_abs_err_reported"] > 1e-9 or not ann._scouting:
            raise SystemExit("(12) a reported distance is not the exact EMD")
        if not row["k8a_launches"]:
            raise SystemExit("(12) the digits-5620 hybrid never launched K8a")
        if not row["k12_launches"] or row["k12_launches"] != row["exact_batches"]:
            raise SystemExit("(12) the digits-5620 hybrid launched K12 %d times for %d exact "
                             "batches" % (row["k12_launches"], row["exact_batches"]))
        if ngi.shape != (len(X), N_NEIGHBORS):
            raise SystemExit("(12) graph of shape %s" % (ngi.shape,))
        return errors

    for run in ("timed", "profiled", "switched"):
        extra = {"max_resident_pairs": pin["m"] // 2} if run == "switched" else {}
        ann = att.Annchor(X, "wasserstein", verbose=run == "timed", **kw, **extra)
        emd = {"s": 0.0, "calls": 0, "batches": 0}
        exact_eval = ann._exact_eval

        def timed_exact(f, X_, IJ, exact_eval=exact_eval, emd=emd):
            t = time.perf_counter()
            try:
                return exact_eval(f, X_, IJ)
            finally:
                emd["s"] += time.perf_counter() - t
                emd["calls"] += len(IJ)
                emd["batches"] += len(IJ) > 0

        ann._exact_eval = timed_exact
        K8.reset_counts()
        K12.reset_counts()
        if run == "profiled":
            row = _device_profile(torch, ann.fit, "sinkhorn_exp_chunk")
            for name, ms, cnt in row["top"]:
                print("    %-60s %10.3f ms in %6d events" % (name, ms, cnt), flush=True)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ann.fit()
            torch.cuda.synchronize()
            row = {"wall_s": time.perf_counter() - t0}
        row.update(exact_emd_s=emd["s"], exact_emd_calls=emd["calls"],
                   k8a_launches=K8.mode_launches["exp"], k12_launches=K12.launches,
                   exact_batches=emd["batches"])
        errors = check(ann, run, row)
        if run == "switched":
            if ann._locality_info["build"] != "budgeted" or ann._dev is None:
                raise SystemExit("(12b) the fit did not switch to the budgeted build")
            continue
        if ann._locality_info["build"] != "admit" or ann._ij_dev[2] != pin["m"]:
            raise SystemExit("(12a) the fit did not keep the admitted %d pairs" % pin["m"])
        # the scout calls follow from the budget; an exact call follows a
        # certify admission, which the scout's last bits can move (its
        # products round once from float64 on the card, XLA:CPU sums in
        # float32): within 1 % of the JAX package's
        if ann.scout_evals != pin["scout_evals"] or abs(ann.evals - pin["evals"]) > (
                0.01 * pin["evals"]):
            raise SystemExit("(12a) exact or scout calls off the JAX package's")
        if errors > pin["errors"] or errors >= DIGITS_MAX_ERRORS:
            raise SystemExit("(12a) %d errors against the exact graph" % errors)


def _k10_bound(torch, enc, I, J):
    """K10's work on these pairs and its bound: (word steps, search
    probes, bound ms, what bounds it, the row DP's cell bound ms).  The
    bound is the larger of (10 x word steps + 2 x probes) INT32
    instructions at the card's INT32 rate and the inputs read once and
    the output written once at its memory rate."""
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import cells, search_probes, word_steps

    steps = word_steps(enc.lengths, I, J)
    probes = search_probes(enc, I, J)
    ops_ms = (steps * K1_OPS_PER_STEP + probes * K10_OPS_PER_PROBE) / INT32_OPS_PER_S * 1e3
    tables = (enc.sym, enc.soff, enc.mask, enc.moff, enc.ids, enc.lengths, I, J)
    nbytes = sum(t.numel() * t.element_size() for t in tables) + 4 * I.shape[0]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    cell_ms = cells(enc.lengths, I, J) * K10_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    return (steps, probes, max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", cell_ms)


def _k10_crossover(torch, np, enc, rng):
    """Kernel-only ms of K10's thread and group modes against the batch
    size on strings-1600 over 256 symbols: the measurement behind
    ``levenshtein_rowdp_cuda.GROUP_LANES_MAX``."""
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import launch, plan_for

    rows = []
    for B in (1_600, 5_000, 20_000, 30_000, 40_000, 50_000, 58_707, 131_072):
        I = torch.as_tensor(rng.integers(0, enc.n, size=B), device="cuda")
        J = torch.as_tensor(rng.integers(0, enc.n, size=B), device="cuda")
        out = torch.empty(B, dtype=torch.int32, device="cuda")
        row = {"pairs": B, "auto": _modes(plan_for(enc, B))}
        for mode in ("thread", "group"):
            plans = plan_for(enc, B, mode)
            row[mode + "_ms"] = _time(torch, lambda: launch(plans, enc, I, J, out), 20)
        rows.append(row)
        print("  K10 crossover %7d pairs (auto: %-6s) thread %8.4f ms, group %8.4f ms"
              % (B, row["auto"], row["thread_ms"], row["group_ms"]), flush=True)
    return rows


def _alpha256(torch, np, att, report, K10):
    """Phase 12(c): strings-1600 over 256 code points, every evaluation on
    K10, with the JAX sample stream, against a BruteForce on K10, its
    launches by mode, then the same fit under ``torch.profiler`` (K10's
    device ms); the sparse table's build time at 256 and 20,000 symbols;
    K10 at the refine batch's shape, an anchor column and BruteForce's
    pairs beside its bound, the row DP's cell bound and its time before
    the redesign (the refine batch also beside the plain version, bit for
    bit); then the thread/group crossover sweep.  Returns (K10's launches
    in the fit by mode, the refine batch's timing row)."""
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding, encode_strings, lev_pairs_plain
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import plan_for, rowdp_pairs_cuda
    from annchor_tpu_torch.ops.tropical_cuda import K4

    X, _ = make_strings(alphabet=ALPHA256)
    X = list(X)
    fit_kw = dict(n_neighbors=N_NEIGHBORS, p_work=P_WORK, random_seed=42,
                  uniforms=jax_threefry_uniforms)
    K10.reset_counts()
    K4.reset_counts()
    ann, wall = _timed_fit(torch, att, X, "levenshtein", **fit_kw)
    modes = dict(K10.mode_launches)
    launches = K10.launches
    k4_launches = K4.launches
    enc = ann.metric.batch._encode(X)
    t0 = time.perf_counter()
    gt = _bruteforce_graph(att, X, "levenshtein")
    bf_s = time.perf_counter() - t0
    errors = att.compare_neighbor_graphs(gt, ann.neighbor_graph, N_NEIGHBORS)
    print("  (c) strings-1600 over 256 symbols: %.3f s, %d evals (JAX package: %d), %d "
          "errors against a BruteForce on K10 (%.3f s; JAX package: %d), K10 launches %d %s, "
          "K4 launches %d" % (wall, ann.evals, ALPHA256_EVALS, errors, bf_s, ALPHA256_ERRORS,
                              launches, modes, k4_launches), flush=True)
    if k4_launches == 0:
        raise SystemExit("(12c) the 256-symbol fit never launched K4")
    if not isinstance(enc, RowDPEncoding) or not (modes["thread"] and modes["group"]):
        raise SystemExit("(12c) the 256-symbol fit did not run on K10 in thread and group "
                         "mode: %s" % modes)
    if ann.evals != ALPHA256_EVALS or errors > ALPHA256_ERRORS:
        raise SystemExit("(12c) the 256-symbol fit differs from the JAX package's figures")
    prof = _device_profile(torch, lambda: att.Annchor(X, "levenshtein", device="cuda",
                                                      **fit_kw).fit())
    print("  (c) the same fit under torch.profiler: K10 %.3f ms in %d kernels, K4 %.3f ms in "
          "%d, of %.3f ms device time in %d kernels, %.3f s wall" % (
              prof["k10_device_ms"], prof["k10_kernels"], prof["k4_device_ms"],
              prof["k4_kernels"], prof["device_ms"], prof["kernels"], prof["wall_s"]),
          flush=True)

    builds = {}
    for label, alphabet in (("256 symbols", ALPHA256), ("20,000 symbols", "".join(_cjk(20_000)))):
        codes, lengths = encode_strings(list(make_strings(alphabet=alphabet)[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = RowDPEncoding(codes, lengths, "cuda")
        torch.cuda.synchronize()
        builds[label] = {"s": time.perf_counter() - t0, "words": int(e.mask.shape[0]),
                         "symbols": int(e.sym.shape[0])}
        print("  sparse table of strings-1600 over %s: %.4f s, %d symbol slots, %d words "
              "(%.1f MB)" % (label, builds[label]["s"], builds[label]["symbols"],
                             builds[label]["words"], builds[label]["words"] * 4e-6),
              flush=True)

    n = len(X)
    rng = np.random.default_rng(12)
    tri = torch.triu_indices(n, n, 1, device="cuda")
    shapes = {
        "refine batch": (torch.as_tensor(rng.integers(0, n, REFINE_BATCH), device="cuda"),
                         torch.as_tensor(rng.integers(0, n, REFINE_BATCH), device="cuda"), 20),
        "anchor column": (torch.tensor(1126, device="cuda").expand(n),
                          torch.arange(n, device="cuda"), 50),
        "BruteForce": (tri[0], tri[1], 3),
    }
    rows = {}
    for name, (I, J, reps) in shapes.items():
        B = int(I.shape[0])
        steps, probes, bound_ms, bound_by, cell_ms = _k10_bound(torch, enc, I, J)
        row = {"pairs": B, "mode": _modes(plan_for(enc, B)),
               "ms": _time(torch, lambda: rowdp_pairs_cuda(enc, I, J), reps),
               "word_steps": steps, "probes": probes, "bound_ms": bound_ms,
               "bound_by": bound_by, "cell_bound_ms": cell_ms,
               "before_ms": BEFORE_K10_MS[name], "plain_ms": None, "max_abs_err": 0}
        if name == "refine batch":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = lev_pairs_plain(enc, I, J)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            got = rowdp_pairs_cuda(enc, I, J)
            row["max_abs_err"] = int((got.long() - want.long()).abs().max())
        row["bound_share"] = bound_ms / row["ms"]
        rows[name] = row
        print("  K10 %-13s %8d pairs %-18s %9.4f ms | %d word steps + %d probes, bound %.4f "
              "ms (%s), %.1f %% of it | row-DP cell bound %.4f ms | plain %s ms | before "
              "%.4f ms" % (
                  name, B, row["mode"], row["ms"], steps, probes, bound_ms, bound_by,
                  100 * row["bound_share"], cell_ms,
                  "not timed" if row["plain_ms"] is None else "%.3f" % row["plain_ms"],
                  row["before_ms"]), flush=True)
        if row["ms"] >= row["before_ms"]:
            print("    not faster than before the redesign (%.4f ms)" % row["before_ms"],
                  flush=True)
    refine = rows["refine batch"]
    if refine["max_abs_err"]:
        raise SystemExit("K10 disagrees with its plain version at the refine batch's shape")
    report["alpha256"] = {"fit_s": wall, "evals": int(ann.evals), "errors": int(errors),
                          "k10_launches": launches, "k10_modes": modes,
                          "k4_launches": k4_launches,
                          "bruteforce_s": bf_s, "profile": prof, "table_builds": builds,
                          "k10": rows, "crossover": _k10_crossover(torch, np, enc, rng)}
    return modes, refine, k4_launches


def _sharded(torch, np, att, K1, report, X, ref4, big_X, ref9):
    """Phase 13: the multi-device fit on a mesh of ``MESH_SHARDS`` shards
    (``ANNCHOR_TPU_MESH_DEVICES``; on one card every shard is that card).
    ``ref4`` is phase 4's JAX-stream graph of strings-1600 and ``ref9``
    phase 9's 100k fit (graph, m, evals, its derived cap, its pair list,
    wall and peak).  Returns (K1's launches per shard in the fits of (a)
    and (b), max |K1 - plain| through the sharded engine)."""
    from annchor_tpu_torch import parallel
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs_plain
    from annchor_tpu_torch.ops.band_linf_cuda import K9A
    from annchor_tpu_torch.ops.locality import candidate_pairs_device_budgeted
    from annchor_tpu_torch.ops.tropical_cuda import K4

    keys = ("ANNCHOR_TPU_MESH_DEVICES", "ANNCHOR_TPU_PAIR_CAP", "ANNCHOR_TPU_BUILD_SCORE")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["ANNCHOR_TPU_MESH_DEVICES"] = str(MESH_SHARDS)
    try:
        mesh = parallel.auto_mesh("cuda")
        cards = len(mesh.distinct)
        report["mesh"] = [str(d) for d in mesh.devices]
        print("  (c) mesh %s: %d shards on %d distinct card(s), %d visible" % (
            ", ".join(report["mesh"]), mesh.size, cards, torch.cuda.device_count()),
            flush=True)
        if mesh.size != MESH_SHARDS or cards != min(MESH_SHARDS, torch.cuda.device_count()):
            raise SystemExit("the mesh does not span the visible cards")

        # K1 through the sharded engine against its plain version
        rng = np.random.default_rng(13)
        I = torch.as_tensor(rng.integers(0, len(X), 20_000), device="cuda")
        J = torch.as_tensor(rng.integers(0, len(X), 20_000), device="cuda")
        eng = att.get_function_from_input("levenshtein", device="cuda").batch
        K1.reset_counts()
        got = eng.batch_dev(X, I, J)
        torch.cuda.synchronize()
        check_shards = dict(K1.shard_launches)
        want = myers_pairs_plain(MyersEncoding.from_codes(*encode_strings(X), "cuda"), I, J)
        err = int((got.long() - want.long()).abs().max())
        print("  (c) K1 vs plain through the sharded engine: 20000 pairs of strings-1600, "
              "K1 launches per shard %s, max|diff|=%d" % (check_shards, err), flush=True)
        if err or sorted(check_shards) != list(range(MESH_SHARDS)):
            raise SystemExit("the sharded engine disagrees with the plain version or "
                             "skipped a shard")

        # (a) strings-1600, dense, the JAX sample stream
        kw = dict(n_neighbors=N_NEIGHBORS, p_work=P_WORK, random_seed=42, device="cuda")
        K1.reset_counts()
        K4.reset_counts()
        t0 = time.perf_counter()
        a = att.Annchor(X, "levenshtein", uniforms=jax_threefry_uniforms, **kw)
        a.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a_shards = dict(K1.shard_launches)
        k4_shards = dict(K4.shard_launches)
        same = all(np.array_equal(g, w) for g, w in zip(a.neighbor_graph, ref4[:2]))
        report.update(sharded1600_fit_s=wall, sharded1600_evals=int(a.evals),
                      sharded1600_k1_launches=K1.launches,
                      sharded1600_k1_shard_launches=a_shards,
                      sharded1600_k4_shard_launches=k4_shards)
        print("  (a) strings-1600 on %d shards: %.3f s (phase 4: %.3f s), %d evals (phase 4: "
              "%d), graph bit-equal to phase 4's: %s, K1 launches %d, per shard %s, K4 "
              "launches per shard %s" % (
                  MESH_SHARDS, wall, report["jax_stream_fit_s"], a.evals, ref4[2], same,
                  K1.launches, a_shards, k4_shards), flush=True)
        if a._dev is None or a._dev.shard is None or a._dev.shard.s != MESH_SHARDS:
            raise SystemExit("the strings-1600 fit did not shard its state")
        if not same or a.evals != ref4[2] or a.evals != REFERENCE_EVALS:
            raise SystemExit("the sharded strings-1600 fit differs from phase 4's")
        if sorted(a_shards) != list(range(MESH_SHARDS)):
            raise SystemExit("a shard never launched K1 in the strings-1600 fit")
        if sorted(k4_shards) != list(range(MESH_SHARDS)):
            raise SystemExit("a shard never launched K4 in the strings-1600 fit")
        del a

        # (b) the 100k scale fit at phase 9's derived cap
        os.environ["ANNCHOR_TPU_PAIR_CAP"] = str(ref9["cap"])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K1.reset_counts()
        K9A.reset_counts()
        b, wall = _timed_fit(torch, att, big_X, "levenshtein", n_neighbors=15,
                             p_work=SCALE100K_P_WORK, random_seed=42)
        peak = torch.cuda.max_memory_allocated() - base
        b_shards = dict(K1.shard_launches)
        k9a_shards = dict(K9A.shard_launches)
        dev = b._dev
        same = all(np.array_equal(g, w) for g, w in zip(b.neighbor_graph, ref9["graph"]))
        ij = b._ij_dev
        same_pairs = ij[2] == ref9["m"] and all(
            torch.equal(g, w) for g, w in zip(ij[:2], ref9["ij"]))
        report.update(sharded100k_fit_s=wall, sharded100k_m=int(ij[2]),
                      sharded100k_evals=int(b.evals), sharded100k_peak_bytes=int(peak),
                      sharded100k_k1_launches=K1.launches,
                      sharded100k_k1_shard_launches=b_shards,
                      sharded100k_k9a_shard_launches=k9a_shards,
                      sharded100k_k9a_modes=dict(K9A.mode_launches))
        print("  (b) 100k on %d shards at cap %d: %.3f s (phase 9: %.3f s), m %d (phase 9: "
              "%d), %d evals (phase 9: %d), graph bit-equal to phase 9's: %s, pair list "
              "equal: %s, K1 launches %d, per shard %s, K9a launches per shard %s %s, peak "
              "device memory above the %.2f GiB held before %.2f GiB (phase 9: %.2f GiB)" % (
                  MESH_SHARDS, ref9["cap"], wall, ref9["wall"], ij[2], ref9["m"], b.evals,
                  ref9["evals"], same, same_pairs, K1.launches, b_shards, k9a_shards,
                  dict(K9A.mode_launches), base / 2**30, peak / 2**30, ref9["peak"] / 2**30),
              flush=True)
        if dev is None or dev.shard is None or dev.shard.s != MESH_SHARDS or not dev.sparse:
            raise SystemExit("the 100k fit did not shard its sparse state")
        for c in range(MESH_SHARDS):
            pair_bytes = sum(t[c].numel() * t[c].element_size() for t in (
                dev.ij_i, dev.ij_j, dev.lb, dev.ub, dev.dad, dev.RA, dev.ncm))
            P = dev.P_idx_d[c]
            print("    shard %d on %s: %d pairs (%.1f MiB), %d x %d incidence rows (%.1f MiB)"
                  % (c, dev.RA[c].device, dev.RA[c].shape[0], pair_bytes / 2**20,
                     P.shape[0], P.shape[1], P.numel() * P.element_size() / 2**20))
        if not same_pairs:
            raise SystemExit("the sharded budgeted build's pairs differ from phase 9's")
        if not same or b.evals != ref9["evals"]:
            raise SystemExit("the sharded 100k fit differs from phase 9's")
        if sorted(b_shards) != list(range(MESH_SHARDS)):
            raise SystemExit("a shard never launched K1 in the 100k fit")
        if sorted(k9a_shards) != list(range(MESH_SHARDS)):
            raise SystemExit("a shard never launched K9a in the 100k fit's band build")
        del b, dev, ij

        # (d) the rms build score on the mesh raises (ROADMAP F3)
        os.environ["ANNCHOR_TPU_BUILD_SCORE"] = "rms"
        D = np.random.default_rng(0).random((600, 16))
        try:
            candidate_pairs_device_budgeted(D, 5, 2, 30, 40, device="cuda")
        except ValueError as exc:
            print("  (d) rms on the mesh raises: %s" % exc, flush=True)
        else:
            raise SystemExit("the rms build score ran on the mesh")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shards = {c: a_shards.get(c, 0) + b_shards.get(c, 0) for c in range(MESH_SHARDS)}
    return shards, err, k4_shards, k9a_shards


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import annchor_tpu_torch as att
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.band_linf_cuda import K9A
    from annchor_tpu_torch.ops.levenshtein_cuda import K1
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import K10
    from annchor_tpu_torch.ops.emd_cuda import K12
    from annchor_tpu_torch.ops.sinkhorn_cuda import K8
    from annchor_tpu_torch.ops.tropical_cuda import K4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    _phase("1. device")
    report["card"] = _card(torch)
    kind = torch.cuda.get_device_name(0)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda, kind))
    from concurrent.futures import ThreadPoolExecutor

    from annchor_tpu_torch.native import EMD

    def build(lib):
        t = time.perf_counter()
        lib.lib()
        return time.perf_counter() - t

    # one compiler process for each source, all started together
    with ThreadPoolExecutor(7) as pool:
        builds = [pool.submit(build, lib) for lib in (K1, K10, K4, K9A, K8, K12, EMD)]
        (report["k1_build_s"], report["k10_build_s"], report["k4_build_s"],
         report["k9a_build_s"], report["k8_build_s"], report["k12_build_s"],
         report["emd_build_s"]) = (b.result() for b in builds)
    for kernel, key in ((K1, "k1"), (K10, "k10"), (K4, "k4"), (K9A, "k9a"), (K8, "k8"),
                        (K12, "k12")):
        print("  built %s in %.3f s" % (kernel.name, report[key + "_build_s"]))
        report[key + "_ptxas"] = _ptxas(kernel)
        for name, (regs, st, ld) in report[key + "_ptxas"].items():
            print("    %-22s %3d registers, spill stores %d B, spill loads %d B"
                  % (name, regs, st, ld))
        if not report[key + "_ptxas"]:
            raise SystemExit("no ptxas report in %s's build log" % kernel.name)
    print("  built the host EMD solver (g++) in %.3f s" % report["emd_build_s"], flush=True)

    _phase("2. kernel check")
    X, _ = make_strings()
    X = list(X)
    report["k1_check_pairs"], max_err = _check_k1(torch, np, X)
    _check_no_sync(torch, np, X)
    _check_oracle(torch, np, X)
    report["k10_check_pairs"], k10_err, report["k10_check_modes"] = _check_k10(torch, np)
    report["encode_check"] = _check_encode(torch, np, X)
    report["k4_check_calls"], k4_err, report["k4_check_launches"], E1600 = _check_k4(
        torch, np, att, X)
    report["k9a_check_calls"], k9a_err, report["k9a_check_modes"] = _check_k9a(torch, np)
    _check_small_fit(torch, np)
    report["scout_card_vs_cpu_rel"] = _check_scout_no_sync(torch, np)
    report["k8_check_calls"], k8_err, report["k8_check"] = _check_k8(torch, np)
    k8_check_launches = dict(K8.mode_launches)

    _phase("3. exact graph")
    t0 = time.perf_counter()
    bf = att.BruteForce(X, "levenshtein", device="cuda")
    bf.fit()
    report["bruteforce_s"] = time.perf_counter() - t0
    gt = bf.neighbor_graph
    print("  BruteForce: %d x %d distances in %.3f s"
          % (len(X), len(X), report["bruteforce_s"]), flush=True)

    _phase("4. fit")
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

    kw = dict(n_neighbors=N_NEIGHBORS, p_work=P_WORK, random_seed=42, device="cuda")
    att.Annchor(X, "levenshtein", **kw).fit()  # warm-up
    torch.cuda.synchronize()

    ann = att.Annchor(X, "levenshtein", verbose=True, **kw)
    K1.reset_counts()
    K4.reset_counts()
    t0 = time.perf_counter()
    ann.fit()
    torch.cuda.synchronize()
    report["fit_s"] = time.perf_counter() - t0
    launches = K1.launches
    k4_fit = K4.launches
    errors = att.compare_neighbor_graphs(ann.neighbor_graph, gt, N_NEIGHBORS)
    ngi, ngd = ann.neighbor_graph
    fit_modes = dict(K1.mode_launches)
    report.update(evals=int(ann.evals), errors=int(errors), k1_launches=launches,
                  k1_mode_launches=fit_modes, k4_launches=k4_fit,
                  anchors=[int(a) for a in ann.A[:5]], m=int(ann.IJs.shape[0]))
    print("  fit: %.3f s, %d evals, %d errors, K1 launches %d %s, K4 launches %d, anchors "
          "%s..." % (report["fit_s"], ann.evals, errors, launches, fit_modes, k4_fit,
                     report["anchors"]), flush=True)
    if launches == 0:
        raise SystemExit("the fit never launched K1")
    if k4_fit == 0:
        raise SystemExit("the fit never launched K4")
    if ann.evals > 1.4 * P_WORK * ann.N + 2 * 5000:
        raise SystemExit("the fit overspent: %d evals" % ann.evals)
    if errors > 2 * REFERENCE_ERRORS:
        raise SystemExit("%d errors against the exact graph" % errors)
    if ngi.shape != (len(X), N_NEIGHBORS) or not np.isfinite(ngd).all():
        raise SystemExit("graph of shape %s or with non-finite distances" % (ngi.shape,))

    # the same fit drawing the JAX package's samples must reproduce the
    # JAX package's result on this set
    ref = att.Annchor(X, "levenshtein", uniforms=jax_threefry_uniforms, **kw)
    K4.reset_counts()
    t0 = time.perf_counter()
    ref.fit()
    torch.cuda.synchronize()
    report["jax_stream_fit_s"] = time.perf_counter() - t0
    k4_jax_stream = K4.launches
    k4_fit += k4_jax_stream
    ref4 = (ref.neighbor_graph[0].copy(), ref.neighbor_graph[1].copy(), int(ref.evals))
    ref_errors = att.compare_neighbor_graphs(ref.neighbor_graph, gt, N_NEIGHBORS)
    report.update(jax_stream_evals=int(ref.evals), jax_stream_errors=int(ref_errors))
    print("  fit with the JAX sample stream: %.3f s, %d evals (JAX package: %d), "
          "%d errors (JAX package: %d), K4 launches %d" % (
              report["jax_stream_fit_s"], ref.evals, REFERENCE_EVALS, ref_errors,
              REFERENCE_ERRORS, k4_jax_stream), flush=True)
    if k4_jax_stream == 0:
        raise SystemExit("the JAX-stream fit never launched K4")
    if ref.evals != REFERENCE_EVALS:
        raise SystemExit("fit spent %d evals, the JAX package %d"
                         % (ref.evals, REFERENCE_EVALS))
    if ref_errors > REFERENCE_ERRORS:
        raise SystemExit("%d errors against the exact graph, the JAX package %d"
                         % (ref_errors, REFERENCE_ERRORS))

    prof = report["fit_profile"] = _device_profile(
        torch, lambda: att.Annchor(X, "levenshtein", **kw).fit())
    print("  fit under torch.profiler: K1 %.3f ms in %d kernels, K4 %.3f ms in %d, of "
          "%.3f ms device time in %d kernels, %.3f s wall" % (
              prof["k1_device_ms"], prof["k1_kernels"], prof["k4_device_ms"],
              prof["k4_kernels"], prof["device_ms"], prof["kernels"], prof["wall_s"]),
          flush=True)

    _phase("5. timing (%s)" % report["card"])
    t0 = time.perf_counter()
    big_X, _ = make_strings(n=SCALE100K_N, n_clusters=32, length=400,
                            mutation_rate=0.01, seed=42, evolve=True)
    big_X = list(big_X)
    report["scale100k_data_s"] = time.perf_counter() - t0
    report["k1_timing"] = _timings(torch, np, X, ann.IJs, big_X)
    refine = report["k1_timing"]["refine batch"]
    report["k4_k9a_timing"] = timing = _k4_k9a_timing(torch, np, E1600)
    del E1600
    report["k8_timing"] = k8_timing = _k8_timing(torch, np)
    report["k12_timing"] = _k12_timing(torch, np)

    _phase("6. vector metrics (%s)" % report["card"])
    X64, _ = make_blobs(4096, 64, 10, 42)
    report["engines"] = _vector_engines(torch, np, att, X64)
    blobs, _ = make_blobs(1000, 2, 10, 42)
    small, report["blobs_fit_s"] = _timed_fit(torch, att, blobs, "euclidean",
                                              n_anchors=10, p_work=0.05)
    blob_errors = att.compare_neighbor_graphs(
        _bruteforce_graph(att, blobs, "euclidean"), small.neighbor_graph, 15)
    report.update(blobs_evals=int(small.evals), blobs_errors=int(blob_errors))
    print("  blobs 1000 x 2: %.3f s, %d evals, %d errors against BruteForce"
          % (report["blobs_fit_s"], small.evals, blob_errors), flush=True)
    if blob_errors != 0:
        raise SystemExit("the blobs contract needs 0 errors, got %d" % blob_errors)
    K4.reset_counts()
    wide, report["blobs4096_fit_s"] = _timed_fit(
        torch, att, X64, "euclidean", n_neighbors=15, p_work=0.05, random_seed=42,
        uniforms=jax_threefry_uniforms)
    k4_blobs = report["blobs4096_k4_launches"] = K4.launches
    wide_errors = att.compare_neighbor_graphs(
        _bruteforce_graph(att, X64, "euclidean"), wide.neighbor_graph, 15)
    report.update(blobs4096_evals=int(wide.evals), blobs4096_errors=int(wide_errors))
    print("  blobs 4096 x 64: %.3f s, %d evals (JAX package: %d), %d errors (JAX "
          "package: %d), K4 launches %d" % (report["blobs4096_fit_s"], wide.evals,
                                            BLOBS4096_EVALS, wide_errors, BLOBS4096_ERRORS,
                                            k4_blobs), flush=True)
    if wide.evals != BLOBS4096_EVALS or wide_errors > BLOBS4096_ERRORS:
        raise SystemExit("the 4096 x 64 fit differs from the JAX package's figures")
    if k4_blobs == 0:
        raise SystemExit("the 4096 x 64 fit never launched K4")

    _phase("7. Python-callable metric (%s)" % report["card"])

    def l1(x, y):
        return float(np.abs(x - y).sum())

    closure, report["closure_fit_s"] = _timed_fit(
        torch, att, blobs, l1, n_anchors=10, p_work=0.05, uniforms=jax_threefry_uniforms)
    closure_errors = att.compare_neighbor_graphs(
        _bruteforce_graph(att, blobs, l1), closure.neighbor_graph, 15)
    report.update(closure_evals=int(closure.evals), closure_errors=int(closure_errors))
    print("  L1 closure on blobs: %.3f s, %d evals (JAX package: %d), %d errors (JAX "
          "package: %d)" % (report["closure_fit_s"], closure.evals, CLOSURE_EVALS,
                            closure_errors, CLOSURE_ERRORS), flush=True)
    if closure.evals != CLOSURE_EVALS or closure_errors != CLOSURE_ERRORS:
        raise SystemExit("the closure fit differs from the JAX package's figures")

    _phase("8. host pipeline (%s)" % report["card"])

    class HostSampler(att.SimpleStratifiedSampler):
        """A do-nothing subclass: custom strategy objects take the host
        pipeline."""

    K1.reset_counts()
    host, report["host_fit_s"] = _timed_fit(
        torch, att, X, "levenshtein", n_neighbors=N_NEIGHBORS, p_work=P_WORK,
        random_seed=42, sampler=HostSampler())
    host_launches = K1.launches
    host_modes = dict(K1.mode_launches)
    host_errors = att.compare_neighbor_graphs(host.neighbor_graph, gt, N_NEIGHBORS)
    report.update(host_evals=int(host.evals), host_errors=int(host_errors),
                  host_k1_launches=host_launches)
    print("  strings-1600 host pipeline: %.3f s, %d evals (JAX package: %d), %d errors "
          "(JAX package: %d), K1 launches %d" % (
              report["host_fit_s"], host.evals, HOST_EVALS, host_errors, HOST_ERRORS,
              host_launches), flush=True)
    if host._dev is not None or host_launches == 0:
        raise SystemExit("the host-pipeline fit did not run the host pipeline on K1")
    if host.evals != HOST_EVALS or host_errors > HOST_ERRORS:
        raise SystemExit("the host-pipeline fit differs from the JAX package's figures")

    # (b) the same custom sampler above 4,096 points: the blocked host pair
    # build, then the host pipeline's per-pair passes on the card
    X5, y5 = make_strings(n=5000, n_clusters=16, length=200, mutation_rate=0.01, seed=42,
                          evolve=True)
    X5 = list(X5)
    gt5 = _bruteforce_graph(att, X5, "levenshtein")
    K1.reset_counts()
    host5, report["host5k_fit_s"] = _timed_fit(
        torch, att, X5, "levenshtein", n_neighbors=15, p_work=0.05, random_seed=42,
        sampler=HostSampler())
    host5_launches = K1.launches
    host5_modes = dict(K1.mode_launches)
    host5_errors = att.compare_neighbor_graphs(gt5, host5.neighbor_graph, 15)
    report.update(host5k_evals=int(host5.evals), host5k_errors=int(host5_errors),
                  host5k_m=int(host5.IJs.shape[0]), host5k_k1_launches=host5_launches)
    print("  (b) strings-5000 host pipeline: %.3f s, m %d, %d evals (JAX package: %d), %d "
          "errors (JAX package: %d), K1 launches %d %s" % (
              report["host5k_fit_s"], host5.IJs.shape[0], host5.evals, HOST5K_EVALS,
              host5_errors, HOST5K_ERRORS, host5_launches, host5_modes), flush=True)
    if host5._dev is not None or host5._ij_dev is not None or host5_launches == 0:
        raise SystemExit("the 5,000-string custom-sampler fit did not run the host pipeline "
                         "on K1")
    if host5.evals != HOST5K_EVALS or host5_errors > 2 * HOST5K_ERRORS + 20:
        raise SystemExit("the 5,000-string host-pipeline fit differs from the JAX package's "
                         "figures")
    host_modes = {m: host_modes[m] + host5_modes[m] for m in host_modes}

    _phase("9. scale path (%s)" % report["card"])
    scale_modes, scale_err, scale5k, big = _scale_path(torch, np, att, K1, report, big_X,
                                                       X5, y5, gt5)
    max_err = max(max_err, scale_err)
    ref9 = dict(graph=tuple(g.copy() for g in big.neighbor_graph), m=int(big._ij_dev[2]),
                evals=int(big.evals), cap=int(big._derived_pair_cap()),
                ij=big._ij_dev[:2], wall=report["scale100k_fit_s"],
                peak=report["scale100k_peak_bytes"])

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    _phase("10. serve (%s)" % report["card"])
    serve_modes = _serve(torch, np, att, K1, report, X, ref, scale5k, big, big_X, out_dir)

    _phase("11. exact oracles and the slow metrics (%s)" % report["card"])
    exact_modes = _slow_metrics(torch, np, att, K1, report, X, gt)

    _phase("12. digits-5620 and the row DP (%s)" % report["card"])
    _digits5620(torch, np, att, report)
    k10_modes, k10_row, k4_alpha = _alpha256(torch, np, att, report, K10)

    _phase("13. the multi-device fit (%s)" % report["card"])
    del big, scale5k  # phase 13 measures its own peak memory
    gc.collect()
    torch.cuda.empty_cache()
    sharded_shards, sharded_err, k4_shards, k9a_shards = _sharded(
        torch, np, att, K1, report, X, ref4, big_X, ref9)
    max_err = max(max_err, sharded_err)
    main_modes = {m: fit_modes[m] + host_modes[m] + scale_modes[m] + serve_modes.get(m, 0)
                  + exact_modes[m] for m in fit_modes}
    # K9a's main path: phase 9(b)'s 100k fit, whose band build it runs
    k9a_main = report["scale100k_k9a_modes"]
    print("  K4 launches: phase 4 %d, blobs 4096 x 64 %d, 256 symbols %d, per shard %s; K9a "
          "launches: 100k fit %s, strings-5000 %s, load(rebuild_pairs) %s, per shard %s" % (
              k4_fit, k4_blobs, k4_alpha, k4_shards, k9a_main, report["scale5k_k9a_modes"],
              report["serve"]["e"]["load_k9a_modes"], k9a_shards))
    print("  K1 launches on the main path (phases 4, 8, 9, 10, 11) by mode: %s; phase 10: "
          "%s; phase 11: %s" % (main_modes, serve_modes, exact_modes))
    if not (main_modes["thread"] and main_modes["group"]):
        raise SystemExit("the main path did not launch both K1 modes: %s" % main_modes)
    # K8's main paths: the hybrids' timed fits (11(b), 12(a)) and the
    # wasserstein_sinkhorn fit (11(c))
    k8a_1797 = report["slow_metrics"]["b"]["fits"][0]["k8a_launches"]
    k8a_5620 = report["digits5620"]["fits"][0]["k8a_launches"]
    k8b_main = report["slow_metrics"]["c"]["k8b_launches"]
    print("  K8 launches: K8a digits-1797 %d, digits-5620 %d; K8b wasserstein_sinkhorn %d"
          % (k8a_1797, k8a_5620, k8b_main))
    # K12's main paths: the hybrids' timed fits' exact batches (11(b), 12(a))
    k12_1797 = report["slow_metrics"]["b"]["fits"][0]["k12_launches"]
    k12_5620 = report["digits5620"]["fits"][0]["k12_launches"]
    k12_rows = report["k12_timing"]
    print("  K12 launches: digits-1797 %d, digits-5620 %d (one an exact batch)"
          % (k12_1797, k12_5620))
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    # K9a's figures: the 100k build's first band (phase 9(b))
    k9a_band = report["k9a_bands"]
    k9a_hist, k9a_keep = k9a_band["K9a hist first"], k9a_band["K9a keep first"]
    print(json.dumps({"kernels": [{
        "name": "levenshtein_myers (K1)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/levenshtein_myers.cu",
        "replaces": "annchor_tpu/ops/levenshtein_pallas.py:63",
        "launches": sum(main_modes.values()),
        "launches_thread": main_modes["thread"],
        "launches_group": main_modes["group"],
        "launches_long": main_modes["long"],
        "launches_serve": sum(serve_modes.values()),
        "launches_exact": sum(exact_modes.values()),
        "launches_sharded": sum(sharded_shards.values()),
        "launches_per_shard": sharded_shards,
        "max_abs_err": max_err,
        "ms": refine["ms"],
        "plain_ms": refine["plain_ms"],
        "bound_ms": refine["bound_ms"],
        "bound_by": refine["bound_by"],
        "library_ms": None,
    }, {
        "name": "levenshtein_rowdp (K10)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/levenshtein_rowdp.cu",
        "replaces": "annchor_tpu/ops/levenshtein.py:96",
        "launches": sum(k10_modes.values()),
        "launches_thread": k10_modes["thread"],
        "launches_group": k10_modes["group"],
        "launches_long": k10_modes["long"],
        "launches_check": report["k10_check_modes"],
        "max_abs_err": max(k10_err, k10_row["max_abs_err"]),
        "ms": k10_row["ms"],
        "plain_ms": k10_row["plain_ms"],
        "bound_ms": k10_row["bound_ms"],
        "bound_by": k10_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "tropical_tighten (K4)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/tropical_tighten.cu",
        "replaces": "annchor_tpu/ops/device_pipeline.py:602",
        "launches": k4_fit,
        "launches_blobs4096": k4_blobs,
        "launches_alpha256": k4_alpha,
        "launches_check": report["k4_check_launches"],
        "launches_per_shard": k4_shards,
        "max_abs_err": max(k4_err, timing["K4 nx 1600"]["max_abs_err"],
                           timing["K4 nx 4096"]["max_abs_err"]),
        "ms": timing["K4 nx 1600"]["ms"],
        "plain_ms": timing["K4 nx 1600"]["plain_ms"],
        "bound_ms": timing["K4 nx 1600"]["bound_ms"],
        "bound_by": timing["K4 nx 1600"]["bound_by"],
        "library_ms": None,
        "ms_nx4096": timing["K4 nx 4096"]["ms"],
        "plain_ms_nx4096": timing["K4 nx 4096"]["plain_ms"],
        "bound_ms_nx4096": timing["K4 nx 4096"]["bound_ms"],
        "bound_ms_dense": timing["K4 nx 1600"]["bound_ms_dense"],
        "bound_ms_dense_nx4096": timing["K4 nx 4096"]["bound_ms_dense"],
    }, {
        "name": "band_linf (K9a)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/band_linf.cu",
        "replaces": "annchor_tpu/ops/locality.py:550",
        "launches": sum(k9a_main.values()),
        "launches_hist": k9a_main["hist"],
        "launches_keep": k9a_main["keep"],
        "launches_scale5k": sum(report["scale5k_k9a_modes"].values()),
        "launches_load": sum(report["serve"]["e"]["load_k9a_modes"].values()),
        "launches_check": report["k9a_check_modes"],
        "launches_per_shard": k9a_shards,
        "max_abs_err": max([k9a_err] + [r["max_abs_err"] for k, r in timing.items()
                                        if k.startswith("K9a")]
                           + [r["max_abs_err"] for r in k9a_band.values()]),
        "shape": k9a_hist["shape"],
        "ms": k9a_hist["ms"],
        "plain_ms": k9a_hist["plain_ms"],
        "bound_ms": k9a_hist["bound_ms"],
        "bound_by": k9a_hist["bound_by"],
        "bound_ms_dense": k9a_hist["bound_ms_dense"],
        "library_ms": k9a_hist["library_ms"],
        "thr_ms": k9a_hist["thr_ms"],
        "thr_plain_ms": k9a_hist["thr_plain_ms"],
        "ms_last": k9a_band["K9a hist last"]["ms"],
        "ms_keep": k9a_keep["ms"],
        "plain_ms_keep": k9a_keep["plain_ms"],
        "bound_ms_keep": k9a_keep["bound_ms"],
        "bound_by_keep": k9a_keep["bound_by"],
        "bound_ms_dense_keep": k9a_keep["bound_ms_dense"],
    }, {
        "name": "sinkhorn_exp (K8a)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "annchor_tpu/ops/wasserstein.py:65",
        "launches": k8a_1797 + k8a_5620,
        "launches_digits1797": k8a_1797,
        "launches_digits5620": k8a_5620,
        "launches_check": k8_check_launches["exp"],
        "max_abs_err": max([r["max_abs_err"] for r in report["k8_check"]
                            if r["kernel"] == "K8a"]
                           + [r["max_abs_err"] for k, r in k8_timing.items()
                              if k.startswith("K8a")]),
        "max_rel_err": max([r["max_rel"] for r in report["k8_check"] if r["kernel"] == "K8a"]
                           + [r["max_rel"] for k, r in k8_timing.items()
                              if k.startswith("K8a")]),
        "shape": [k8_timing["K8a chunk"]["pairs"], 64, k8_timing["K8a chunk"]["n_iter"]],
        "ms": k8_timing["K8a chunk"]["ms"],
        "plain_ms": k8_timing["K8a chunk"]["plain_ms"],
        "bound_ms": k8_timing["K8a chunk"]["bound_ms"],
        "bound_by": k8_timing["K8a chunk"]["bound_by"],
        "library_ms": k8_timing["K8a chunk"]["library_ms"],
        "library_call": "torch.mm float64 (cuBLAS), 2 n_iter + 2 products",
        "ms_column": k8_timing["K8a column"]["ms"],
        "plain_ms_column": k8_timing["K8a column"]["plain_ms"],
        "bound_ms_column": k8_timing["K8a column"]["bound_ms"],
        "library_ms_column": k8_timing["K8a column"]["library_ms"],
        "large_n": {k: {f: r[f] for f in ("n", "pairs", "n_iter", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
                    for k, r in k8_timing.items() if k.startswith("K8a n ")},
    }, {
        "name": "sinkhorn_log (K8b)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/sinkhorn.cu",
        "replaces": "annchor_tpu/ops/wasserstein.py:24",
        "launches": k8b_main,
        "launches_check": k8_check_launches["log"],
        "max_abs_err": max([r["max_abs_err"] for r in report["k8_check"]
                            if r["kernel"] == "K8b"] + [k8_timing["K8b chunk"]["max_abs_err"]]),
        "max_rel_err": max([r["max_rel"] for r in report["k8_check"] if r["kernel"] == "K8b"]
                           + [k8_timing["K8b chunk"]["max_rel"]]),
        "model_bit_equal": all(r["model_equal"] for r in report["k8_check"]
                               if r["kernel"] == "K8b"),
        "shape": [k8_timing["K8b chunk"]["pairs"], 64, k8_timing["K8b chunk"]["n_iter"]],
        "plan": k8_timing["K8b chunk"]["plan"],
        "ms": k8_timing["K8b chunk"]["ms"],
        "plain_ms": k8_timing["K8b chunk"]["plain_ms"],
        "bound_ms": k8_timing["K8b chunk"]["bound_ms"],
        "bound_by": k8_timing["K8b chunk"]["bound_by"],
        "bound_ms_fp32": k8_timing["K8b chunk"]["bound_ms_fp32"],
        "library_ms": None,
        # the profiler may miss launches: its count of them beside
        "device_ms_fit": report["slow_metrics"]["c"]["k8b_device_ms"],
        "device_kernels_fit": report["slow_metrics"]["c"]["k8b_kernels"],
        "large_n": {k: {f: r[f] for f in ("n", "pairs", "n_iter", "plan", "launches_per_call",
                                          "ms", "plain_ms", "bound_ms", "bound_by",
                                          "bound_ms_fp32", "bytes_ms_sweeps", "library_ms")
                        if f in r}
                    for k, r in k8_timing.items() if k.startswith("K8b n ")},
    }, {
        "name": "emd_simplex (K12)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/emd_simplex.cu",
        "replaces": None,  # the JAX package's exact EMD is host C++
        "launches": k12_1797 + k12_5620,
        "launches_digits1797": k12_1797,
        "launches_digits5620": k12_5620,
        "launches_exact_knn": report["slow_metrics"]["b"]["exact_knn_k12_launches"],
        "max_abs_err": 0.0,  # bit-equal to the host solver and the plain version, or exit
        "pairs": k12_rows["K12 certify 5620"]["pairs"],
        "ms": k12_rows["K12 certify 5620"]["ms"],
        "bound_ms": k12_rows["K12 certify 5620"]["bound_ms"],
        "bound_by": k12_rows["K12 certify 5620"]["bound_by"],
        "host_ms": k12_rows["K12 certify 5620"]["host_ms"],
        "plain_pairs": k12_rows["K12 certify 5620"]["sample_pairs"],
        "plain_ms": k12_rows["K12 certify 5620"]["plain_ms"],
        "ms_plain_pairs": k12_rows["K12 certify 5620"]["sample_ms"],
        "library_ms": None,
        "pairs_query": k12_rows["K12 query 1797"]["pairs"],
        "ms_query": k12_rows["K12 query 1797"]["ms"],
        "bound_ms_query": k12_rows["K12 query 1797"]["bound_ms"],
        "host_ms_query": k12_rows["K12 query 1797"]["host_ms"],
        "plain_ms_query": k12_rows["K12 query 1797"]["plain_ms"],
        "ms_plain_pairs_query": k12_rows["K12 query 1797"]["sample_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
