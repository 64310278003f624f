#!/usr/bin/env python3
"""Smoke run of lightgbm_torch on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py [--seed 0] [--rows 1000000] [--trees 500]
                          [--train-iters 20] [--sampled-iters 40]
                          [--backend-iters 10]

Phases, each printing one JSON line:

0. device: the card (``nvidia-smi``), torch and CUDA versions.
1. build: every CUDA kernel of the package compiled from ``csrc/`` with
   nvcc for sm_90a, all sources at once.
2. small: seeded models over data with NaN, zero-as-missing, categorical
   and EFB-bundled features (binary and 3-class, with and without
   prediction early stop) served through ``train(..., 0, init_model=...)``
   and ``Booster.predict``.  The prediction kernel (K1) must equal its plain
   PyTorch version bit for bit (both add the same float32 leaf values in the
   same tree order), and ``predict`` must match the float64 host walk within
   rtol 1e-4 / atol 1e-5.
3. train_small: 20 000 rows of numeric features with NaN, a zero-heavy
   column and an EFB-bundled pair, 127 leaves at a split budget of 64 (so
   every tree ends in the route-only sprint round), 5 iterations on the CPU
   (plain versions) and on the card (kernels).  Dyadic custom gradients
   must give byte-identical model text; the binary objective the same first
   tree and raw scores within atol 2e-4; and every K2 and K4 launch of the
   card's binary run, and of a run at the default max_bin 255 (more slots
   than one block holds), replayed through the plain version on the card,
   must be bit-equal.  Dyadic runs with ``hist_backend`` scatter and pallas
   at max_bin 63 and 255 must give one text per max_bin on the CPU and the
   card, every card launch of K5, K6 and K7 bit-equal to its plain version.
   The growth constraints (``CONSTRAINT_ARMS``) and the monotone methods
   and per-node draws (``METHOD_ARMS``: K = 1 and K = 3, the three
   backends, fused against the CPU, max_bin 255 and quantized) must give
   CPU == card text, every card launch replayed bit-equal; so must the
   growth extras (``EXTRA_ARMS``: CEGB, forced splits, linear trees and
   all three together; K = 1 and K = 3, the three backends, the forced
   tree fused against the CPU, max_bin 255 and quantized).
4. train_sampled_small: the train_small data on dyadic custom gradients
   with bagging (half the rows every iteration) and with GOSS (rates 0.5 /
   0.25, learning rate 0.5): byte-identical model text on the CPU and the
   card, with route fusion on and off and, for GOSS, row compaction pad and
   off; every K2, K3 and K4 launch of the card's fused runs replayed
   bit-equal through its plain version, and each K3 launch against the
   chain of route-only K2 launches it fuses; the same under scatter
   (compaction auto, pad, off) and pallas (uncompacted), CPU and card, one
   text, their card launches replayed.
5. train_quantized_small: the train_small rows with ``use_quantized_grad``
   on custom gradients whose quantization scales are powers of two:
   binary, K = 3 lockstep, GOSS and ``quant_train_renew_leaf`` give
   byte-identical text on the CPU and the card, the card's runs through
   K2's int form (never its float form), every int launch replayed
   bit-equal through its plain version; then ``nan_guard`` on the card:
   NaN init scores train as zeros would, and NaN gradients at the 2nd of
   4 updates grow a no-op tree without ending training.
6. full: the repo's north-star shape, HIGGS-like data (28 numeric features,
   max_bin 63) and a seeded synthetic 500-tree x 255-leaf binary model
   written as LightGBM model text: ``Dataset`` over 1M rows (binned on the
   card by ``bin_rows``), ``train(params, ds, 0, init_model=path)``,
   ``predict`` on 1M more rows (uploaded raw and binned on the card).  The
   kernels' launch counts are read around that ``predict`` call alone; its
   ``bin_rows`` launch and the Dataset's are replayed through the plain
   version and held to the host's ``construct_binned`` byte for byte, and
   timed (``predict_breakdown_s``: tables, upload, binning; beside it the
   host binning and bins upload predict ran before); then K1
   is held bit for bit against its plain version on all rows, the scores
   against the host walk on a 20 000-row subsample, and the kernel, the
   plain version, the host walk and ``predict`` are timed; the line also
   gives the kernel's launch plan, its node visits, the share of its
   lanes' steps that walk a node, the packed node bytes the visits read
   and the bytes its stages copy from L2 into shared memory.
7. train: the full phase's Dataset trained through ``lightgbm_torch.train``
   (binary, 255 leaves, learning rate 0.1, split budget 64) for
   ``--train-iters`` iterations with the kernel counts read around that
   call; the model predicts the held-out rows through K1 (AUC > 0.80); the
   first 3 trees are trained again and must repeat byte for byte; every K2
   and K4 launch of one tree is replayed through its plain version on the
   card (bit-equal) and then timed one by one beside its plain version and
   bound; one more iteration is timed phase by phase.  Its arms: the
   constrained one, and the intermediate and advanced monotone methods and
   by-node sampling with extra trees (``higgs_method_arms``), each fused
   and eager, its AUC gate, K1's monotone sweeps, one tree's K2 and K4
   launches replayed; and the growth extras: CEGB (eager; split counts on
   the penalised features below the plain arm's, AUC > 0.75, the lazy
   bitset's bytes), forced splits (fused and eager, every tree's top three
   nodes the forced ones, the fused text equal to the eager text, AUC >
   0.80) and linear trees (5 eager trees, the host fit's seconds and share
   of a tree, coefficients in every tree after the first, the held-out
   rows through the host walk, AUC > 0.80), one tree's K2 and K4 launches
   replayed in each.  Then checkpoints (``CHECKPOINT_ARMS``, fused: 10
   iterations with a snapshot every 5, the run resumed from the first
   snapshot byte-identical to the uninterrupted one, plain and with
   bagging 0.8 and feature_fraction 0.8; the seconds to write and to
   resume), DART (drop_rate 0.1, skip_drop 0.5, fused) and RF (bagging
   0.7, eager), ``--train-iters`` trees each (s a tree, held-out AUC on
   250 000 rows, K2 / K4 launches, one tree's launches replayed; DART's
   dropped trees an iteration and the share spent walking them), and the
   refit of the plain model on 1M fresh rows through K3 (one launch a
   tree, each bit-equal to ``route_replay_plain``, the refitted text equal
   to the plain version's; K3 timed; the share of the refit the host's
   sums take).  The last line before the kernels line gives each phase's
   seconds.
7a. predict_surface_small: models trained on the card over 20 000 rows
   (train_small's rows binary, zero-as-missing and K = 3;
   train_categorical_small's; train_wide_small's 16-bit bins), each
   predicting 20 000 other rows: ``pred_leaf`` through K1's leaf form (one
   launch a class, the 16-bit form on 16-bit bins) equal to the host walk
   leaf for leaf; ``pred_contrib`` through the TreeSHAP kernel within
   1e-9 of each row's scale of the exact float64 host walk, the kernel
   within 1e-10 of its plain version and byte-identical when repeated; the
   categorical model on the host walk (no launch, the same bytes); the
   stock LightGBM fixtures (``stock_binary.model`` on ``golden_X.csv``):
   contributions through the kernel within 1e-12 of
   ``stock_pred_binary_contrib.txt``, leaf ids exact; a leaf-wise model
   (split budget 1, 255 leaves, max_depth 24, label exp(3 min_j x_j) over
   28 normal columns) whose paths reach at least 20 unique slots: the
   kernel within 1e-10 of its plain version on 20 000 rows, within 1e-9
   of the host walk on 1 000, and the same bytes launched over row chunks
   of 4096.
7b. predict_surface: ``pred_leaf`` of phase full's 500 x 255-leaf model on
   200 000 of its rows (the kernel counts read around that ``predict``: one
   leaf-form launch), equal to the host walk on 20 000 of them and to the
   plain version on all, the kernel timed beside its bound (the bins, the
   walk's node words and bitsets read, 4 bytes a (row, tree) written);
   ``pred_contrib`` of a
   binary 255-leaf model trained as phase train trains (``--train-iters``
   trees; at ``max_depth`` 24 if a tree is deeper than the kernel takes,
   which the line says) on 100 000 held-out rows (the counts read around
   that ``predict``: one TreeSHAP launch), a repeated launch byte-identical,
   the kernel within 1e-10 of its plain version on 10 000 rows and within
   1e-9 of the exact host walk on 2 000, contributions summing to the
   float64 host raw score within 1e-9 on every row; the kernel timed
   beside its bound (the float64 operations its algorithm needs on these
   rows, ``shap_work``: the extend, the hot slots' unwinding, the cold
   slots' one sum, at the card's float64 rate; beside it the textbook
   count of earlier runs, 3 d (d + 1) + 5 d^2 a (row, leaf)) and its plan
   at 100 000 and 10 000 rows; ``gate``: the exact host walk
   and ``predict(pred_contrib=True)`` on the card timed on 1 and 256 rows
   of the first 2 trees (no batch size gates the device path).
8. train_sampled: the same Dataset with GOSS at the default rates (0.2 /
   0.1), feature_fraction 0.8, learning rate 0.1, ``--sampled-iters``
   iterations (10 of warmup) and 250 000 held-out rows as a validation set
   with AUC and early stopping, the kernel counts read around that call
   (valid AUC > 0.80, one K3 launch per sampled tree); the same trees with
   route fusion off; A/B arms in turns (fused, unfused, no compaction)
   growing the same trees; three sampled trees again, byte for byte; one
   sampled tree's K2, K3 and K4 launches replayed bit-equal, then timed; a
   sampled and an uncompacted iteration timed phase by phase.
9. train_backends: the non-stream growth path at full width, the full
   phase's rows at max_bin 63 and the same rows binned at 255, through
   ``lightgbm_torch.train`` with ``hist_backend`` scatter (K5) and pallas
   (K6 at 63, K7 at 255): binary, 255 leaves, learning rate 0.1, split
   budget 64, ``--backend-iters`` iterations, the kernel counts read around
   each call (its kernel launched, K2 never); scatter and pallas give
   byte-identical text at each max_bin and a second run repeats it (one
   more iteration of it timed phase by phase); held-out AUC > 0.80; one
   tree's K5/K6/K7 launches replayed bit-equal, then timed beside their
   bound and one ``index_add_`` call.
10. train_quantized: the full phase's Dataset trained through
   ``lightgbm_torch.train`` with ``use_quantized_grad`` at LightGBM's
   defaults (4 levels, stochastic rounding): binary, 255 leaves, learning
   rate 0.1, split budget 64, ``--train-iters`` iterations, the kernel
   counts read around the call (K2's int form launched, its float form
   never); held-out AUC > 0.80; the first 3 trees repeat byte for byte;
   arms with renewed leaves, 16 levels rounded to nearest and
   ``hist_backend="scatter"`` (K5 over the grid values); a bagged arm for
   compacted launches; every K2 int launch of one tree replayed bit-equal,
   then timed (full histogram, route-only, compacted) beside its bound and
   one int32 ``index_add_`` call; one more iteration timed phase by phase.
10a. train_regression_small: the other objectives on both devices, on
   train_small's rows with labels from its logit, 127 leaves at a split
   budget of 64, 5 iterations.  regression_l1, quantile at alpha 0.75 and
   mape on labels whose 1 / max(1, |y|) are powers of two (dyadic
   gradients, exact histograms, order statistics in the leaf renewal)
   give byte-identical text on the CPU and the card, also bagged (K3);
   huber, fair, poisson, tweedie, gamma, cross_entropy and
   cross_entropy_lambda the same first tree and raw scores within 2e-4 of
   their scale, fused on the card with text equal to the card's eager
   run; every K2, K3 and K4 launch of the card's runs replayed bit-equal.
10b. train_regression: the regression cell, the full phase's held-out
   1M HIGGS-shaped rows as ``Dataset(..., reference=ds)`` with labels
   from the generator's logit (a Laplace-noised target, Poisson counts, a
   gamma target, a probability), the last 250 000 rows held out; 255
   leaves, learning rate 0.1, split budget 64, ``--train-iters``
   iterations of each of the ten objectives (regression_l1, quantile at
   0.9 and mape eager, renewing their leaves on the card; the others
   fused, each beside an eager arm of byte-identical text), a bagged
   regression_l1 arm (K3) and a quantized one (K2's int form,
   ``quant_train_renew_leaf``); each arm's held-out metric after
   ``predict`` (K1, then ``convert_output``) must beat the constant
   model's; ``s_per_tree``, host reads, launches and the renewal's device
   ms per arm; one tree per arm replayed bit-equal; its numbers go into
   the kernels line's ``regression`` entries.
11. train_multiclass_small: the train_small rows with a 3-class label, 127
   leaves, split budget 64, 5 iterations (15 trees).  Dyadic multiclass
   custom gradients under ``hist_backend`` stream (K2 over K > 1 classes),
   scatter and pallas (K8) must give byte-identical text on the CPU and
   the card; on the card, the lockstep and per-class paths must give
   identical text on real softmax gradients under each backend; every
   K2 and K8 launch of the card's lockstep runs is replayed bit-equal
   through its plain version.
12. train_multiclass: the multiclass cell at full width, bench.py's
   ``make_multiclass_like`` (28 features, K = 10, seed 17) at
   1 000 000 rows, the last 100 000 held out: 255 leaves, max_bin 63,
   learning rate 0.1, split budget 64, 10 iterations through
   ``lightgbm_torch.train`` under stream (K2 over K > 1 classes, the kernel
   counts read around the call), then pallas and scatter (K8), which must
   grow byte-identical text; a per-class arm (``multiclass_batched`` off,
   5 iterations) byte-identical to the lockstep run's first 5 iterations;
   a binary probe on ``y % 2`` with the same rows and leaf budget; held-out
   top-1 accuracy through ``Booster.predict`` (> 0.5, chance 0.1); one
   iteration's K2 and K8 launches replayed bit-equal, then timed beside
   their bound and one ``index_add_`` call; a quantized arm (5 lockstep
   iterations through K2's int form over the 10 classes), one iteration's
   int launches replayed and timed.
13. train_categorical_small: 20 000 rows of train_small's numeric columns
   and three categorical ones (3 categories, 40 with NaN and negative
   values, 200 Zipf-distributed), dyadic custom gradients on the CPU and
   the card, byte-identical text under stream (127 leaves, the sprint
   round), scatter and pallas at max_bin 63 and 255, GOSS and bagging
   (never fused: K3 is not launched), K = 3 lockstep under stream and
   pallas, and quantized gradients; every K2 (both forms), K4, K5, K6, K7
   and K8 launch of the card's runs replayed bit-equal; K1 on a binary
   model trained on the card, over rows with unseen, NaN and negative
   categories, bit-equal to its plain version and within rtol 1e-4 / atol
   1e-5 of the host walk; the categorical splits per tree by kind
   (one-hot, sorted, reversed).
14. train_categorical: the categorical cell, rows in the shape of the
   airline delay task of szilard/GBM-perf (Month, DayofMonth, DayOfWeek,
   UniqueCarrier, Origin and Dest categorical, 250 airports each; DepTime,
   Distance), ``--rows`` trained and a quarter as many held out, binary,
   255 leaves, max_bin 255, learning rate 0.1, ``--train-iters`` iterations
   at the default categorical parameters, the kernel counts read around
   training (K2, K4) and around the held-out ``predict`` (K1); held-out
   AUC beside a run with every column numeric; one tree's K2 and K4
   launches replayed and timed beside the bound and ``index_add_``; K1 on
   the model against its plain version and timed; one iteration timed
   phase by phase.
15. train_wide_small: groups wider than 256 bins (16-bit bins) on both
   devices: 20 000 rows of two dense columns and six mutually exclusive
   sparse ones that EFB bundles at the default max_bin 255 (3 groups, one
   of 1525 bins), dyadic custom gradients (quantized: power-of-two scales)
   under stream, scatter, pallas, GOSS (fused: K3), bagging, quantized
   gradients and K = 3 lockstep under stream and scatter, byte-identical
   text on the CPU and the card, every card run through its kernel's
   16-bit form, pallas's card text equal to scatter's; every K2 (three
   forms), K3, K4, K5, K7 and K8 launch replayed bit-equal; K1 over 16-bit
   bins bit-equal to its plain version and within rtol 1e-4 / atol 1e-5 of
   the host walk.
16. train_wide: the LightGBM paper's Flight Delay set in shape: make_airline_
   like's rows at 300 airports with Month, DayofMonth, DayOfWeek,
   UniqueCarrier, Origin and Dest one-hot encoded (672 columns) beside
   DepTime and Distance, 500 000 rows trained and 100 000 held out; binary, 255 leaves, max_bin 255, default EFB (groups past 256
   bins), learning rate 0.1, ``--train-iters`` iterations under auto
   (stream); arms with GOSS at the default rates (15 iterations, 10 of
   warmup: K3), scatter (10: K5), quantized gradients (5: K2's int form)
   and K = 3 under scatter on 200 000 of the rows (3: K8); held-out
   ``predict`` through K1 (AUC > 0.60); the group count, each group's
   bins, Bmax, ``s_per_tree``, ``train_s``; one tree's launches of each arm
   replayed bit-equal and timed beside the bound and ``index_add_``; one
   iteration timed phase by phase.  It raises if no group passes 256 bins.
   A pallas arm (10 iterations: K7's 16-bit form) must grow scatter's text.
   The Dataset and the held-out rows are binned on the card (16-bit),
   every ``bin_rows`` launch held to its plain version and the host.
17. train_ranking_small: learning to rank on both devices, about 20 000
   documents in ragged queries of 1 to ~400 (several query buckets, the
   generic gather path), grades 0-4, a display-position column, 127
   leaves at a split budget of 64, 5 iterations; arms lambdarank, quantized
   (64 levels), ``bagging_by_query`` (K3), position-debiased lambdarank and
   rank_xendcg.  The card's gradients within atol 5e-6 of the CPU's (the
   CPU tests' tolerance), each arm's first tree the same on both devices,
   fused and eager text byte-identical on the card where the arm fuses
   (all but rank_xendcg), every K2 (both forms), K3 and K4 launch replayed
   bit-equal.
18. train_ranking: the repo's second north star (bench.py ``run_ranking``)
   at full width: ``make_mslr_like(2 270 000, 136)`` (copied here), the
   last 10 % of the queries held out; lambdarank, 255 leaves, learning rate
   0.1, max_bin 63, quantized gradients at 64 levels, 30 iterations fused,
   an eager arm of the same trees (byte-identical), a short unquantized arm
   (K2) and a ``bagging_by_query`` arm (K3); held-out ``predict`` through
   K1 and NDCG@10 >= 0.75 (bench.py's gate); one tree's launches of each
   arm replayed bit-equal and timed; the gradients' time and share of a
   tree, the set-up seconds, one eager iteration phase by phase.  Its
   numbers go into the kernels line's ``ranking`` entries.
18a. train_sparse_small: SciPy sparse input on both devices.  bin_csr
   on ``csr_adversarial_cases`` (explicit zeros and -0.0, unsorted rows,
   duplicate (row, column) entries, NaN, +-inf, categories past 2**63,
   overlapping EFB bundles, 8- and 16-bit output, both layouts, float32
   and int64 data, empty rows and columns, N = 1, uploads in chunks; a
   row several tiles long with duplicates along it, 600 lone groups in
   the plan's wide form (group ranges) in both layouts, tile cuts inside
   runs of empty rows; it raises unless those forms ran):
   every launch byte-equal to its plain version on the card and to the
   host (``construct_binned_sparse``; the predict form to ``bin_rows`` on
   the dense rows).  On ``make_sparse_small`` (20 000 rows, 336 columns:
   NaN / inf columns, a sparse categorical column, one-hot blocks bundled
   in 8 and 16 bits): dyadic custom-gradient text byte-identical from the
   CSR Dataset on the CPU and the card, from the dense and the CSC input,
   with ``zero_as_missing`` off and on; ``reset_parameter`` (a
   learning-rate list, num_leaves / lambda_l2 / min_data_in_leaf changed
   at iteration 3) fused equal to eager on the card (two graph runners,
   each capturing and replaying) and the card equal to the CPU on dyadic
   gradients; ``save_binary`` -> ``Dataset(path)`` -> the same text;
   ``subset`` equal to the parent's bins of its rows; ``cv`` over 3 folds
   and 5 rounds, each fold's text equal to ``train`` on its subset.
18b. train_sparse: the Allstate insurance-claim data of LightGBM's
   experiments in shape (``make_allstate_like``: 4 228 one-hot columns of
   30 seeded categorical sources, about 28.5 entries a row), 1M rows
   trained from a CSR Dataset (bin_csr, counted) and 250 000 held out
   through ``create_valid`` with AUC; 255 leaves, learning rate 0.1,
   split budget 64, 20 iterations fused beside an eager arm; held-out
   AUC > 0.70 beside the generator's own; ``predict`` on the held-out CSR
   with the counts read around it (one bin_csr launch, K1's 16-bit form,
   no host walk), within rtol 1e-4 / atol 1e-5 of the host walk; the old
   path (dense slabs, host walk) and the new timed on 20 000 rows;
   ``construct_s`` split (mappers, EFB, bins) beside the host
   ``construct_binned_sparse``; bin_csr on a 100 000-row chunk equal to
   its plain version and timed beside its bound, and its predict form
   (the held-out ``predict``'s launch) timed too, each with its launch
   plan and its tiles' rows and entries; ``cv`` over 5 stratified
   folds, 10 rounds, early stopping after 3, fused and eager.  Its bin_csr
   numbers are the kernels line's ``bin_csr`` entry.
19. hist_adversarial: K5, K8 and both forms of K2 launched on synthetic
   inputs made from ``--seed`` (outside any main path's launch counts),
   each held bit-equal to its plain version: every row in slot 0 and bin
   0, weights at the fixed-point shift's edge (sums near 2**61) and, for
   K2's int form, grid values of -127 and 127 at its int32 gate, S = 64 at
   Bmax 255, K = 10 x S = 64 at Bmax 63 and 255 (several pair tiles), G =
   1, N = 1, N = 0, no row in a slot, and a ragged row count with
   unaligned operands; for K2 at K = 1 and K = 10, also EFB-bundled, NaN,
   zero-as-missing and categorical route records; K6 and K7 over block
   plans with one slot taking every row, edge weights, single-row and
   empty slots, pad blocks, S = 64, 300 groups over group tiles, G = 1,
   N = 0 and 1, and a ragged end with unaligned operands (K7 at Bmax 129,
   200, 255 and 256, G = 27); and K3 over EFB, NaN and zero-as-missing
   records, children outside the tree, R = 0, 1 and 17, 16 383 leaves (the
   packed table in global memory), 3000 groups, N = 0 and 1, and a ragged
   row count with unaligned bins; each list also over 16-bit bins (Bmax
   257, 1524, past a tile's shared memory so that tiles hold a range of
   bins, 40 000; K = 10; N = 0, 1 and ragged; unaligned bins; K3 records
   with thresholds and missing bins past 255; K7 at Bmax 257, 301, 700
   and 1525, the top bin, empty slots, and bin-tiled plans at 12 000 and
   40 000 bins).  After the cells, so that they run as they did before it
   existed.
20. predict_adversarial: K1 on synthetic trees and bins made from
   ``--seed``, each class bit-equal to its plain version: NaN, zero, EFB
   and categorical nodes, early stop, trees of 16 383 leaves (walked from
   global memory) and 40 000 (children past 16 bits), a chain 63 deep with
   and without a depth bound of 9, single-leaf trees, K = 3, N = 1, a
   ragged N, 3000 groups (bins in global memory), unaligned bins; then
   16-bit bins (thresholds and bins past 32 767, NaN bins past 510, every
   form of the kernel).
21. bin_adversarial: ``bin_rows`` on rows made from ``--seed``
   (``BIN_ADVERSARIAL``): NaN, +-inf, -0.0, every bound and one ulp either
   side under MISSING_NAN, MISSING_ZERO and none; categorical features of
   5000 categories (past 4096 and 256 bins), of 20 and of 256, with
   negative, non-integer, unseen and |v| >= 2**63 values; an EFB bundle of
   overlapping sparse features; uint8 and 16-bit output, rows and
   transposed; the predict form's sentinels (widened past 255); N = 1,
   ragged N; Flight-Delay-shaped EFB bundles (``BIN_BUNDLES``: 72 one-hot
   columns, two or three hot in some rows; 72 columns of four non-default
   bins, a 16-bit bundle) in both layouts and widths, the 16-bit ones in
   upload chunks (launches at row0 > 0), a ragged last tile; and rows too
   wide for a block's ring (30 000 and 8000 features, the bundles first,
   read from global memory), each byte-equal to its plain version on the
   card and to the host (``construct_binned`` or the old sentinel
   re-bin); the tables in shared memory and in global memory.
22. shap_adversarial: the TreeSHAP kernel on synthetic trees made from
   ``--seed`` (``shap_adversarial_trees``: a single leaf, a stump, two
   slots, chains of 23 and 24 unique slots, a 24-deep chain over 7
   features, full trees with leaves of count 0) at K = 1 and K = 3, over
   1, 31, 33 and 10 000 rows with NaN, +-0.0 and +-1e-36 at nodes of
   missing type none, zero and nan: within 1e-10 of its plain version,
   1e-9 of the host walk, additive within 1e-9, the same bytes repeated,
   under one tree group or several, with or without shared decision
   words, its accumulators in shared or device memory, and in row
   chunks.

Training on the card runs the fused iteration by default (``fused_iter``
auto): each iteration's head, rounds and tail replayed as CUDA graphs,
their kernels' launches credited per replay.  The launch captures of the
phases above run the fused steps without graphs
(``utils.graphs.uncaptured``), on the same code and shapes.  Phases train,
train_sampled, train_quantized, train_categorical, train_multiclass
(stream), train_wide and train_ranking each add an eager arm
(``fused_iter`` off, the same iterations): its model text must equal the
fused run's byte for
byte, and the line's ``fused_iter`` entry gives both arms' ``s_per_tree``
(and the fused arm's over the iterations that only replayed graphs), host
reads, graph replays and kernel launches per tree, and the idle share of
one more iteration (``torch.profiler``).  The small phases hold L2
regression fused on the card against eager on the CPU, byte for byte
(multiclass: fused against eager on the card, softmax rounding apart).

Then a ``kernels`` line (each ported kernel's launches on its main path,
largest error against its plain version, time, plain time, bound and
library time; K5's entry also ``by_max_bin``, its replayed launches'
times at max_bin 63 and 255; K1's, K2's and K4's also ``categorical``, the
same numbers on the categorical cell; K1's, K2's, K2 int's, K3's, K5's, K7's
and K8's also ``wide``, their 16-bit forms' numbers on the Flight Delay
cell; K1's, K2's, K2 int's, K3's and K4's also ``ranking``, their
numbers on the MSLR-shaped cell, and ``regression``, on the regression
cell; ``bin_rows``, which replaces no TPU
kernel but the JAX package's
native host binner, its launches in phase full's ``predict``; K1's
``leaf`` entry, its leaf form on phase predict_surface's ``pred_leaf``;
``tree_shap``, which replaces no TPU kernel but the JAX package's jitted
device TreeSHAP, its launch in that phase's ``pred_contrib`` and, as
``plain_ms``, its plain version's time on ``plain_rows`` of the rows,
beside the kernel's on the same rows, ``ms_plain_rows``; ``bin_rows``'
and ``tree_shap``'s entries also give their launch plans; ``bin_csr``, which
replaces no TPU kernel but the JAX package's host
``construct_binned_sparse``, its launches on the Allstate-shaped cell's
Dataset, validation set and ``predict``; its plan, and its predict form's
times as a ``predict`` entry),
the card's name and power limit as
nvidia-smi prints them, and as the last line ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero; without a CUDA device
the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM rate, and the
# float32 rate outside the tensor cores.  The data sheet gives no int32 rate;
# the float32 one counts an FMA as two operations, so it is the highest rate
# the card's CUDA cores are quoted at and the bound it gives is the least.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# the float64 rate outside the tensor cores (NVIDIA data sheet, H100 SXM):
# TreeSHAP's bound
FP64_OPS_PER_S = 34e12

RTOL, ATOL = 1e-4, 1e-5
# the device the sparse phases put their own tensors on (a CPU rehearsal of
# them sets "cpu")
CARD = "cuda"
KERNEL_SOURCES = {
    "predict_stream": "lightgbm_torch/kernels/csrc/predict_stream.cu",
    "route_and_hist": "lightgbm_torch/kernels/csrc/route_and_hist.cu",
    "route_and_hist_int": "lightgbm_torch/kernels/csrc/route_and_hist.cu",
    "route_replay": "lightgbm_torch/kernels/csrc/route_replay.cu",
    "leaf_gather": "lightgbm_torch/kernels/csrc/leaf_gather.cu",
    # K5 and K8: two entry points of one source
    "scatter_hist": "lightgbm_torch/kernels/csrc/hist_rows.cu",
    "hist_direct": "lightgbm_torch/kernels/csrc/hist_sorted.cu",
    "hist_nibble": "lightgbm_torch/kernels/csrc/hist_sorted.cu",
    "hist_wide": "lightgbm_torch/kernels/csrc/hist_rows.cu",
    "bin_rows": "lightgbm_torch/kernels/csrc/bin_rows.cu",
    # K1's leaf form: another entry point of K1's source
    "predict_leaf": "lightgbm_torch/kernels/csrc/predict_stream.cu",
    "tree_shap": "lightgbm_torch/kernels/csrc/tree_shap.cu",
    "bin_csr": "lightgbm_torch/kernels/csrc/bin_csr.cu"}
KERNEL_REPLACES = {
    "predict_stream": "lightgbm_tpu/pallas/predict_kernel.py:176",
    "route_and_hist": "lightgbm_tpu/pallas/stream_kernel.py:580",
    # the same pallas_call with int_weights=True (its branch :342-386)
    "route_and_hist_int": "lightgbm_tpu/pallas/stream_kernel.py:580",
    "route_replay": "lightgbm_tpu/pallas/stream_kernel.py:694",
    "leaf_gather": "lightgbm_tpu/pallas/stream_kernel.py:742",
    "scatter_hist": "lightgbm_tpu/pallas/scatter_hist_kernel.py:103",
    "hist_direct": "lightgbm_tpu/pallas/hist_kernel.py:158",
    "hist_nibble": "lightgbm_tpu/pallas/hist_kernel.py:194",
    "hist_wide": "lightgbm_tpu/pallas/hist_kernel.py:305",
    # no pallas_call: the JAX package bins rows on the host, in native C++
    "bin_rows": "lightgbm_tpu/native/binner.cpp:164",
    # K1's form for pred_leaf; the JAX package walks each tree on the host
    # there (lightgbm_tpu/basic.py:1414-1418)
    "predict_leaf": "lightgbm_tpu/pallas/predict_kernel.py:176",
    # no pallas_call: the JAX package's device TreeSHAP, a jitted lax.scan
    "tree_shap": "lightgbm_tpu/shap.py:337",
    # no pallas_call: the JAX package fills a sparse Dataset's bins on the
    # host, construct_binned_sparse
    "bin_csr": "lightgbm_tpu/binning.py:988"}
# the histogram kernels of the non-stream backends
HIST_KERNELS = ("scatter_hist", "hist_direct", "hist_nibble")


_T0 = time.perf_counter()


_PHASE_WALL = []


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the
    script started (``wall_s``)."""
    if "phase" in obj:
        obj = {**obj, "wall_s": time.perf_counter() - _T0}
        _PHASE_WALL.append((obj["phase"], obj["wall_s"]))
    print(json.dumps(obj), flush=True)


def phase_seconds():
    """Each emitted phase's seconds: its ``wall_s`` less the phase's
    before it."""
    out, last = {}, 0.0
    for name, wall in _PHASE_WALL:
        out[name] = out.get(name, 0.0) + wall - last
        last = wall
    return out


# --------------------------------------------------------------------------
# data and models, all from a seed
# --------------------------------------------------------------------------

def make_higgs_like(n, f, seed):
    """HIGGS-shaped task: 28 continuous features and a nonlinear logit (the
    generator of bench.py, copied)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-1.2 * higgs_logit(X)))
    y = (rs.rand(n) < p).astype(np.float64)
    return X, y


def higgs_logit(X):
    """make_higgs_like's logit of its rows."""
    return (2.0 * X[:, 0] - 1.4 * X[:, 1] + 1.2 * X[:, 2] * X[:, 3]
            + 0.8 * np.sin(3 * X[:, 4]) + 0.7 * X[:, 5] * X[:, 5]
            - 0.6 * np.abs(X[:, 6]) + 0.5 * X[:, 7])


def make_mixed(n, seed):
    """NaNs (column 0), a zero-heavy column (1), a categorical column with
    NaN (2), a mutually exclusive sparse pair that EFB bundles (3, 4), and
    dense noise; labels in {0, 1, 2}."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 7)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    X[:, 2] = rs.randint(0, 8, n)
    X[rs.rand(n) < 0.05, 2] = np.nan
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
    X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    y = rs.randint(0, 3, n).astype(np.float64)
    return X, y


def adversarial_categories(X, col, seed):
    """Category values the training data never had: NaN, unseen, negative,
    fractional and far out of range."""
    rs = np.random.RandomState(seed)
    X = X.copy()
    n = len(X)
    for frac, v in ((0.05, np.nan), (0.03, 77.0), (0.03, -3.0), (0.03, 2.7),
                    (0.01, 1e12)):
        X[rs.rand(n) < frac, col] = v
    return X


def random_tree(rs, mappers, num_leaves, cat_prob=0.1):
    """A tree grown leaf-wise by splitting a random leaf num_leaves-1 times.
    Numeric thresholds are drawn from the bin upper bounds of the feature;
    categorical nodes send a random subset of the seen categories left.
    Leaf values are float32-representable, in +-0.1."""
    from lightgbm_torch.binning import BIN_CATEGORICAL, MISSING_NAN
    from lightgbm_torch.tree import Tree

    feats = [f for f, m in enumerate(mappers) if not m.is_trivial]
    ni = num_leaves - 1
    split_feature = np.zeros(ni, np.int32)
    threshold = np.zeros(ni, np.float64)
    decision_type = np.zeros(ni, np.uint8)
    left = np.zeros(ni, np.int32)
    right = np.zeros(ni, np.int32)
    cat_boundaries, cat_threshold = [0], []
    slot = {0: None}          # leaf -> (parent node, is left child)
    for s in range(ni):
        leaf = int(rs.choice(sorted(slot)))
        if slot[leaf] is not None:
            p, is_left = slot[leaf]
            (left if is_left else right)[p] = s
        left[s], right[s] = ~leaf, ~(s + 1)
        slot[leaf], slot[s + 1] = (s, True), (s, False)
        cats = [f for f in feats if mappers[f].bin_type == BIN_CATEGORICAL]
        nums = [f for f in feats if f not in cats]
        f = int(rs.choice(cats if cats and rs.rand() < cat_prob else nums))
        m = mappers[f]
        split_feature[s] = f
        if m.bin_type == BIN_CATEGORICAL:
            chosen = [int(c) for c in m.categories if rs.rand() < 0.5]
            words = np.zeros(max(chosen, default=0) // 32 + 1, np.uint32)
            for c in chosen:
                words[c // 32] |= np.uint32(1 << (c % 32))
            threshold[s] = len(cat_boundaries) - 1
            cat_threshold.extend(int(w) for w in words)
            cat_boundaries.append(len(cat_threshold))
            decision_type[s] = 1
        else:
            n_num = m.num_bins - (1 if m.missing_type == MISSING_NAN else 0)
            threshold[s] = float(m.upper_bounds[rs.randint(max(n_num - 1, 1))])
            decision_type[s] = (Tree.make_decision_type(
                False, bool(rs.rand() < 0.5), int(m.missing_type)))
    leaf_value = rs.uniform(-0.1, 0.1, num_leaves).astype(np.float32)
    z = np.zeros
    return Tree(num_leaves=num_leaves, split_feature=split_feature,
                threshold_bin=np.where(decision_type & 1, threshold,
                                       0).astype(np.int32),
                threshold=threshold, decision_type=decision_type,
                left_child=left, right_child=right, split_gain=z(ni),
                internal_value=z(ni), internal_weight=z(ni),
                internal_count=z(ni),
                leaf_value=leaf_value.astype(np.float64),
                leaf_weight=z(num_leaves), leaf_count=z(num_leaves),
                cat_boundaries=np.asarray(cat_boundaries, np.int32),
                cat_threshold=np.asarray(cat_threshold, np.uint32))


def write_model(path, trees, num_feature, k):
    """LightGBM model text holding ``trees`` (k trees per iteration)."""
    from lightgbm_torch.model_io import tree_to_string

    objective = ("binary sigmoid:1" if k == 1
                 else f"multiclass num_class:{k}")
    body = [tree_to_string(t, i) for i, t in enumerate(trees)]
    head = ["tree", "version=v4", f"num_class={k}",
            f"num_tree_per_iteration={k}", "label_index=0",
            f"max_feature_idx={num_feature - 1}", f"objective={objective}",
            "feature_names=" + " ".join(f"Column_{i}"
                                        for i in range(num_feature)),
            "tree_sizes=" + " ".join(str(len(s) + 1) for s in body), ""]
    Path(path).write_text("\n".join(head) + "\n" + "\n".join(body)
                          + "\nend of trees\n")


def ops_needed(rec):
    """Operations one routing step needs on these inputs, for each node
    record of one tree ((L, 16) int32, kernels/predict.NODE_FIELDS): bin
    address, threshold compare, child select and leaf test (4); a
    categorical node adds the bitset word address (1), an EFB-bundled node
    the unbundling (subtract, range test, adjust: 3), and each missing-value
    bin of a numeric node its test (compare, and: 2)."""
    from lightgbm_torch.kernels import predict as tpk

    is_cat = rec[:, tpk.F_ISCAT] > 0
    missing = ((rec[:, tpk.F_HASNAN] > 0).astype(np.int64)
               + (rec[:, tpk.F_HASMZ] > 0))
    return (4 + is_cat + 3 * (rec[:, tpk.F_BUNDLED] > 0)
            + 2 * np.where(is_cat, 0, missing))


def walk_record_bytes(rec):
    """Bytes of packed node words the kernel reads at each node of one tree
    (kernels/predict.pack_nodes): the two walk words (8); at a special node
    (NaN or zero bin, EFB, categorical) the flags and 32-bit children (12);
    at an EFB node its span, default bin and bin count (12); at a
    categorical node its bitset base and one bitset word (8)."""
    from lightgbm_torch.kernels import predict as tpk

    is_cat = rec[:, tpk.F_ISCAT] > 0
    bundled = rec[:, tpk.F_BUNDLED] > 0
    special = (is_cat | bundled | (rec[:, tpk.F_HASNAN] > 0)
               | (rec[:, tpk.F_HASMZ] > 0))
    return 8 + 12 * special + 12 * bundled + 8 * is_cat


def path_sum(inp, use, node_weight, max_depth):
    """Sum over all rows of ``node_weight`` over the nodes each row visits,
    computed by the kernel itself walking a table of per-leaf path sums in
    place of the leaf values (float32 sums of integers below 2**24 are
    exact).  The launch is not on the main path and the count was read."""
    import torch
    from lightgbm_torch.kernels import predict as tpk

    nodes, lv, words, _ = inp.classes[0]
    recs = tpk.unpack_nodes(nodes).cpu().numpy()
    tab = np.zeros(tuple(lv.shape), np.float32)
    for i, t in enumerate(use):
        sums = tpk.leaf_path_sums(t, node_weight(recs[i]))
        tab[i, :len(sums)] = sums
    out = tpk.predict_stream_cuda(inp.bins_T, nodes,
                                  torch.as_tensor(tab, device=lv.device),
                                  words, max_depth)
    return float(out.double().sum().item())


def walk_lane_efficiency(bins_T, nodes, depth_tab, words, max_depth,
                         rows_per_tile):
    """The share of K1's lane steps that walk a node: each warp (32
    consecutive rows of a tile of ``rows_per_tile``) takes as many steps in
    a tree as its deepest row, so a shallower row's lane idles.  Each row's
    depth in each tree comes from the kernel walking that tree alone with
    ``depth_tab`` ((T, L) float32 leaf depths) in place of the leaf values;
    these launches are not on the main path and the count was read."""
    import torch
    import torch.nn.functional as F
    from lightgbm_torch.kernels import predict as tpk

    n = bins_T.shape[1]
    R = rows_per_tile
    tiles = -(-n // R)
    Rw = 32 * -(-R // 32)
    done = warp = 0.0
    for t in range(nodes.shape[1]):
        d = tpk.predict_stream_cuda(bins_T, nodes[:, t:t + 1].contiguous(),
                                    depth_tab[t:t + 1].contiguous(), words,
                                    max_depth)
        d = F.pad(d, (0, tiles * R - n)).view(tiles, R)
        d = F.pad(d, (0, Rw - R)).view(tiles, Rw // 32, 32).double()
        done += float(d.sum().item())
        warp += 32.0 * float(d.max(dim=-1).values.sum().item())
    return done / warp if warp else 1.0


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events around
    each call from an idle device: the host's enqueue is in the time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20, clock_hz=2e9):
    """Device milliseconds of one call of ``fn``: ``reps`` calls queued
    behind a spin kernel that outlasts their enqueue (twice the host time of
    ``reps`` calls), with the events between the calls, so the time is the
    device's alone and not the host's launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 2e-3) * clock_hz))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class TimedIters:
    """Times every boosting iteration (``GBDT.train_one_iter``, the device
    synchronised at its end) while active, and captures the K2, K3 and K4
    launches of iteration ``capture_at`` into ``cap``.  ``replayed`` marks
    the fused iterations that only replayed graphs (no step run eagerly or
    captured)."""

    def __init__(self, capture_at=None):
        self.seconds, self.cap, self.capture_at = [], Capture(), capture_at
        self.replayed = []

    def __enter__(self):
        import torch
        from lightgbm_torch.models.gbdt import GBDT
        self._orig = orig = GBDT.train_one_iter

        def timed(eng, *a, **kw):
            g = eng._graphs
            before = (g.captures, g.eager_runs)
            t0 = time.perf_counter()
            with (self.cap if len(self.seconds) == self.capture_at
                  else contextlib.nullcontext()):
                out = orig(eng, *a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.replayed.append(bool(eng._fused)
                                 and (g.captures, g.eager_runs) == before)
            return out

        GBDT.train_one_iter = timed
        return self

    def __exit__(self, *exc):
        from lightgbm_torch.models.gbdt import GBDT
        GBDT.train_one_iter = self._orig


def profiled_iteration(bst):
    """One more iteration of ``bst``, its phases timed (the device
    synchronised at every phase boundary): (seconds, phase seconds, host
    reads)."""
    from lightgbm_torch.utils.timer import PhaseTimer

    timer = PhaseTimer(bst.engine.device)
    bst.engine.timer = timer
    t0 = time.perf_counter()
    bst.update()
    bst.engine._flush_models()
    seconds = time.perf_counter() - t0
    bst.engine.timer = None
    return seconds, dict(timer.seconds), timer.host_reads


def idle_share(bst):
    """One more iteration of ``bst`` under ``torch.profiler``: (the share of
    the iteration's wall time, from its start to the device's end, in which
    no kernel ran on the card, its seconds).  Busy time is the union of the
    kernels' intervals in the trace (graph replays' kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # the raw trace: parsing it into the profiler's event tree takes
    # seconds an iteration of ~10^5 kernels
    spans = sorted((e.start_ns() * 1e-3, e.end_ns() * 1e-3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        return None, wall
    return max(0.0, 1.0 - busy * 1e-6 / wall), wall


def arm_numbers(bst, timed, launches, reads, trace=True):
    """An arm's per-tree numbers: ``s_per_tree`` (median after the first
    iteration; fused, also the median of the iterations that only replayed
    graphs), host reads, graph replays and kernel launches per iteration,
    and, with ``trace``, the idle share of one more iteration
    (``idle_share``; None without)."""
    eng = bst.engine
    iters = max(len(timed.seconds), 1)
    replayed = [t for t, r in zip(timed.seconds, timed.replayed) if r]
    graph_replays, captures = eng._graphs.replays, eng._graphs.captures
    share, share_s = idle_share(bst) if trace else (None, None)
    return {"fused": bool(eng._fused),
            "s_per_tree": statistics.median(timed.seconds[1:]
                                            or timed.seconds),
            "s_per_tree_replayed": (statistics.median(replayed)
                                    if replayed else None),
            "iterations_replayed": len(replayed),
            "host_reads_per_tree": reads / iters,
            "graph_replays_per_tree": graph_replays / iters,
            "graph_captures": captures,
            "kernel_launches_per_tree": sum(launches.values()) / iters,
            "loop_rounds": list(eng._loop_rounds),
            "idle_share": share, "idle_share_iteration_s": share_s}


# the eager arm of a fused run: its first trees, their median after the
# first its s per tree
EAGER_ITERS = 4


def fused_and_eager(fused_bst, fused_timed, fused_launches, fused_reads,
                    train, iters):
    """The fused main run against the same training with ``fused_iter``
    off (``train(extra, n)``, n the first ``EAGER_ITERS`` of ``iters``):
    byte-identical model text on the card for those trees, and both arms'
    numbers.  Raises unless the main run fused."""
    from lightgbm_torch import kernels
    from lightgbm_torch.utils.timer import host_reads

    iters = min(iters, EAGER_ITERS)

    if not fused_bst.engine._fused or fused_bst.engine._graphs.replays == 0:
        raise RuntimeError("the main run did not replay fused graphs")
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters() as timed:
        eager = train({"fused_iter": "off"}, iters)
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    if eager.engine._fused:
        raise RuntimeError("fused_iter=off fused")
    if model_trees_text(eager) != model_trees_text(fused_bst,
                                                  num_iteration=iters):
        raise RuntimeError("fused and eager iterations grow different "
                           "trees")
    return {"text_identical": True,
            "fused": arm_numbers(fused_bst, fused_timed, fused_launches,
                                 fused_reads),
            "eager": arm_numbers(eager, timed, launches, reads)}


def fused_against_cpu(X, y, params, iters, **ds_kw):
    """L2 regression fused on the card against eager on the CPU: the same
    float32 gradients and exact sums, so byte-identical text."""
    import lightgbm_torch as lt

    texts = {}
    for dev, fused in (("cuda", "on"), ("cpu", "off")):
        p = {**params, "objective": "regression", "device_type": dev,
             "fused_iter": fused}
        bst = lt.train(p, lt.Dataset(X, label=y, params=p, **ds_kw), iters)
        if bst.engine._fused != (dev == "cuda"):
            raise RuntimeError(f"fused_iter={fused} on {dev}")
        texts[dev] = model_trees_text(bst)
    if texts["cuda"] != texts["cpu"]:
        raise RuntimeError(f"fused on the card differs from eager on the "
                           f"CPU under {params}")
    return True


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def serve(X, y, trees, k, params, ds_kw, tmp):
    """A saved model served through the public entry points: model text ->
    Dataset -> train(0, init_model) -> Booster."""
    import lightgbm_torch as lt

    path = Path(tmp) / f"model_{len(trees)}_{k}.txt"
    write_model(path, trees, X.shape[1], k)
    return lt.train(params, lt.Dataset(X, label=y, **ds_kw), 0,
                    init_model=str(path))


def check_kernel_against_plain(bst, X, es=None):
    """Run the CUDA kernel and its plain version on the inputs of a device
    batch walk; raise unless they are equal bit for bit.  Returns the
    inputs, the kernel's outputs and the largest difference seen (0.0)."""
    import torch
    from lightgbm_torch.kernels import predict as tpk

    use, k, _, _ = bst._resolve_tree_slice(0, None)
    inp = bst._device_predict_inputs(X, use, k, es)
    if inp is None:
        raise RuntimeError("the device path declined this batch")
    outs, err = [], 0.0
    for nodes, lv, words, depths in inp.classes:
        got = tpk.predict_stream_cuda(inp.bins_T, nodes, lv, words,
                                      int(max(depths)), inp.es_freq,
                                      inp.es_margin)
        want = tpk.predict_stream_plain(inp.bins_T, nodes, lv, words, depths,
                                        inp.es_freq, inp.es_margin)
        diff = (got - want).abs().max().item() if len(got) else 0.0
        if not torch.equal(got, want):
            raise RuntimeError(f"CUDA kernel differs from its plain version "
                               f"(max abs {diff})")
        outs.append(got)
        err = max(err, diff)
    return inp, outs, err


def k1_work(inp, use, max_depth, rows):
    """Bytes and operations one K1 launch needs on these rows (one class):
    the bins, packed nodes, leaf values and categorical words read once and
    the scores written; the operations of each node visit from its node's
    flags, plus one add per row and tree."""
    nodes, lv, words, _ = inp.classes[0]
    n_ops = path_sum(inp, use, ops_needed, max_depth) + rows * len(use)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (inp.bins_T, nodes, lv, words)) + 4 * rows
    return n_bytes, n_ops


# ------------------------------------------------------------------------
# rows binned on the card (bin_rows)
# ------------------------------------------------------------------------

def host_predict_bins(X, mappers, groups, cat_feats):
    """The (N, G) host bins that ``Booster.predict`` walked before rows were
    binned on the card: ``construct_binned`` with the training mappers and
    groups, widened to uint16 where a split categorical feature has more
    than 255 bins, each such feature's NaN, negative and unseen values
    re-binned to its sentinel bin ``num_bins``.  The oracle of bin_rows'
    predict form."""
    from lightgbm_torch.binning import construct_binned, device_group_order

    bins = construct_binned(X, mappers, groups).bins
    if (bins.dtype == np.uint8 and cat_feats
            and max(mappers[f].num_bins for f in cat_feats) > 255):
        bins = bins.astype(np.uint16)
    group_of = {f: gi for gi, g in enumerate(
        device_group_order(groups, mappers)) for f in g}
    for f in sorted(cat_feats):
        m = mappers[f]
        v = X[:, f]
        ivc = np.where(np.isnan(v), -1.0, v)
        ivc = np.clip(ivc, -1.0, float(2 ** 62)).astype(np.int64)
        ok = (ivc >= 0) & np.isin(ivc, m.categories.astype(np.int64))
        bins[~ok, group_of[f]] = m.num_bins
    return bins


class BinCapture:
    """Records every ``bin_rows`` call (its chunk of rows, tables, output
    and first row) while active, by wrapping the dispatcher that
    ``bin_matrix`` calls.  The calls still go through the kernel's wrapper
    and are counted there."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from lightgbm_torch.kernels import bin_rows as br
        self._orig = orig = br.bin_rows

        def call(x, tables, out, row0=0, transpose=False):
            res = orig(x, tables, out, row0, transpose)
            self.calls.append((x, tables, out, row0, transpose))
            return res

        br.bin_rows = call
        return self

    def __exit__(self, *exc):
        from lightgbm_torch.kernels import bin_rows as br
        br.bin_rows = self._orig


def replay_bin_rows(cap, host=None):
    """Every captured bin_rows launch through its plain version on the card
    (the same chunk and tables, a fresh output); raises unless the bins are
    equal byte for byte, and, where ``host`` (N, G) host bins are given,
    unless the captured output equals them too.  Returns the launches
    replayed and the largest difference of bin values."""
    import torch
    from lightgbm_torch.kernels import bin_rows as br
    from lightgbm_torch.kernels.layout import bin_values, bins_to_numpy

    outs = {}
    for x, tables, out, row0, transpose in cap.calls:
        want = outs.setdefault(id(out), (out, torch.zeros_like(out)))[1]
        br.bin_rows_plain(x, tables, want, row0, transpose)
    err = 0.0
    for out, want in outs.values():
        err = max(err, max_abs_diff(bin_values(out), bin_values(want)))
        if not torch.equal(out, want):
            raise RuntimeError(f"bin_rows differs from its plain version "
                               f"(max abs {err})")
    if host is not None:
        (out, transpose) = (cap.calls[-1][2], cap.calls[-1][4])
        got = bins_to_numpy(out)
        got = got.T if transpose else got
        if got.dtype != host.dtype or not np.array_equal(got, host):
            raise RuntimeError(f"bin_rows differs from the host bins "
                               f"({got.dtype} {got.shape} against "
                               f"{host.dtype} {host.shape})")
    return len(cap.calls), err


def split_cat_features(use):
    """The categorical features the trees split on: those whose values
    ``Booster.predict`` bins in the predict form (sentinels)."""
    cats = set()
    for t in use:
        ni = max(t.num_leaves - 1, 0)
        dt = np.asarray(t.decision_type[:ni]).astype(np.int64)
        cats.update(int(f) for f in
                    np.asarray(t.split_feature[:ni])[(dt & 1) > 0])
    return cats


def predict_replayed(bst, X, **kw):
    """``Booster.predict`` on the host rows X with its bin_rows launches
    captured, each replayed through the plain version on the card, and the
    card's bins held byte for byte to the host's old path
    (``host_predict_bins``).  Returns the prediction, the seconds it took,
    the capture, and the launches replayed and their largest difference."""
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    with BinCapture() as cap:
        t0 = time.perf_counter()
        pred = bst.predict(X, **kw)
        seconds = time.perf_counter() - t0
    if not cap.calls:
        raise RuntimeError("predict binned no rows on the card")
    tb = bst.engine.train_data.binned
    with np.errstate(invalid="ignore"):
        host = host_predict_bins(np.asarray(X, np.float64), tb.bin_mappers,
                                 tb.group_features, split_cat_features(use))
    return (pred, seconds, cap) + replay_bin_rows(cap, host)


def construct_replayed(ds, X):
    """``Dataset.construct`` on the card with its bin_rows launches
    captured, each replayed through the plain version on the card, and the
    card's bins held byte for byte to ``construct_binned`` on the host.
    Returns the seconds ``construct`` took (the checks after it not
    counted), the capture, the launches replayed and their largest
    difference."""
    from lightgbm_torch.binning import construct_binned
    with BinCapture() as cap:
        t0 = time.perf_counter()
        ds.construct()
        seconds = time.perf_counter() - t0
    b = ds.binned
    with np.errstate(invalid="ignore"):
        host = construct_binned(X, b.bin_mappers, b.group_features).bins
    if not np.array_equal(b.bins, host):
        raise RuntimeError("a Dataset's host copy of its card bins differs "
                           "from construct_binned")
    return (seconds, cap) + replay_bin_rows(cap, host)


def bin_rows_work(x, tables):
    """Bytes and operations one bin_rows launch needs: each raw value read
    once, each group's bin written once, the tables read once; per value of
    a feature in a group a binary search (one compare a level, two more for
    the NaN test and the assembly)."""
    from lightgbm_torch.kernels import bin_rows as br
    n = x.shape[0]
    tab_bytes = sum(t.numel() * t.element_size() for t in (
        tables.feats, tables.group_start, tables.col_entry, tables.bounds,
        tables.cats, tables.cat_bins))
    n_bytes = x.numel() * 8 + n * tables.num_groups * tables.out_bytes \
        + tab_bytes
    levels = sum(int(max(r[br.F_BOUNDS_LEN], r[br.F_CATS_LEN])).bit_length()
                 + 2 for r in tables.host_feats)
    return n_bytes, n * levels


def time_bin_rows(cap):
    """The largest captured bin_rows launch timed: the kernel
    (``device_ms``, into a scratch output), its plain version (CUDA events,
    one call) and its bound."""
    import torch
    from lightgbm_torch.kernels import bin_rows as br

    x, tables, out, _, transpose = max(cap.calls,
                                       key=lambda c: c[0].shape[0])
    n = x.shape[0]
    scratch = torch.empty((tables.num_groups, n) if transpose
                          else (n, tables.num_groups), dtype=out.dtype,
                          device=out.device)
    ms = device_ms(lambda: br.bin_rows_cuda(x, tables, scratch, 0,
                                            transpose), reps=10)
    plain = cuda_ms(lambda: br.bin_rows_plain(x, tables, scratch, 0,
                                              transpose), reps=1, warmup=0)
    bnd = bound(*bin_rows_work(x, tables))
    return {"rows": n, "features": int(x.shape[1]),
            "groups": tables.num_groups, "out_bytes": tables.out_bytes,
            "transpose": bool(transpose),
            "plan": list(br.launch_plan(x, tables)), "ms": ms,
            "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def bin_adversarial_data(seed, n):
    """Mappers, groups and (n, F) rows for bin_rows' edge cases, from
    ``seed``: numeric features under MISSING_NAN (0), MISSING_ZERO (1) and
    none (2); categorical features of 5000 categories (3, past the host's
    4096-category path and 256 bins), 20 (4, negative values dropped) and
    256 (5, whose sentinel bin passes uint8); and three sparse numeric
    features (6, 7, 8) with overlapping non-zeros, bundled into one group.
    The rows mix draws with NaN, +-inf, -0.0, each bound and one ulp on
    either side of it, and for the categorical columns unseen, negative,
    non-integer and |v| >= 2**63 values."""
    from lightgbm_torch.binning import BinMapper

    rs = np.random.RandomState(seed)
    m = 20_000
    s_nan = rs.randn(m)
    s_nan[rs.rand(m) < 0.1] = np.nan
    s_zero = np.where(rs.rand(m) < 0.3, 0.0, rs.randn(m))
    s_none = rs.randn(m) * 100
    mappers = [BinMapper.find_numerical(s_nan, 255, 3, True, False),
               BinMapper.find_numerical(s_zero, 63, 3, True, True),
               BinMapper.find_numerical(s_none, 63, 3, False, False),
               BinMapper.find_categorical(
                   np.concatenate([np.arange(5000), rs.randint(0, 6000, m)]),
                   5000, 1, True),
               BinMapper.find_categorical(rs.randint(-3, 20, m), 255, 1,
                                          True),
               BinMapper.find_categorical(
                   np.concatenate([np.arange(256), rs.randint(0, 256, m)]),
                   256, 1, True)]
    sparse = []
    for _ in range(3):
        col = np.where(rs.rand(m) < 0.2, rs.rand(m) + 0.5, 0.0)
        mappers.append(BinMapper.find_numerical(col, 15, 3, True, False))
        sparse.append(col)
    F = len(mappers)
    X = np.zeros((n, F))
    for f, mp in enumerate(mappers):
        if mp.bin_type == 1:
            cats = mp.categories.astype(np.float64)
            special = np.array([np.nan, np.inf, -np.inf, -0.0, -0.5, -1.0,
                                -7.0, 0.5, 2.0 ** 62, 2.0 ** 63, -2.0 ** 63,
                                1e19, -1e19, 1e300, cats.max() + 1,
                                cats.max() + 1000, 3.7])
            pick = rs.rand(n)
            col = rs.choice(cats, n)
            col = np.where(pick < 0.2, rs.choice(special, n), col)
            col = np.where((pick > 0.2) & (pick < 0.3),
                           col + rs.choice([0.25, 0.75, -0.25], n), col)
            edges = special
        else:
            ub = mp.upper_bounds[np.isfinite(mp.upper_bounds)]
            edges = np.concatenate([ub, np.nextafter(ub, np.inf),
                                    np.nextafter(ub, -np.inf)]) \
                if len(ub) else np.zeros(1)
            special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                                np.nextafter(0.0, 1.0),
                                np.nextafter(0.0, -1.0)])
            pick = rs.rand(n)
            col = (rs.choice(sparse[f - 6], n) if f >= 6
                   else rs.randn(n) * (100 if f == 2 else 1))
            col = np.where(pick < 0.3, rs.choice(edges, n), col)
            col = np.where((pick > 0.3) & (pick < 0.4),
                           rs.choice(special, n), col)
        # every edge value at least once, in the first rows
        k = min(n, len(edges))
        col[:k] = edges[:k]
        X[:, f] = col
    groups = [[0], [1], [2], [3], [4], [5], [6, 7, 8]]
    return mappers, groups, X


# (label, rows, features of bin_adversarial_data's mappers, sentinel
# features, transpose)
BIN_ADVERSARIAL = (
    ("b16_rows", 250_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (), False),
    ("b16_transposed", 250_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (), True),
    ("b8_rows", 1_000_003, (0, 1, 2, 4, 6, 7, 8), (), False),
    ("b8_transposed", 1_000_003, (0, 1, 2, 4, 6, 7, 8), (), True),
    ("predict_b16", 250_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (3, 4, 5), True),
    ("predict_b8_widened", 100_003, (0, 1, 2, 4, 5, 6, 7, 8), (4, 5),
     True),
    ("predict_b8", 100_003, (0, 1, 2, 4, 6, 7, 8), (4,), True),
    ("n1", 1, (0, 1, 2, 3, 4, 5, 6, 7, 8), (3,), True),
)


def bin_bundle_data(seed, n, width=72):
    """Mappers, groups and (n, 1 + 2 width) rows of two Flight-Delay-shaped
    EFB bundles, from ``seed``: feature 0 numeric with NaN, alone; features
    1 .. width one-hot 0/1 columns (an airport: one hot a row, a second in
    10 % of the rows and a third in 2 %, so that two or more features of
    the bundle are non-default) in one bundle of width + 1 bins; features
    width + 1 .. 2 width sparse columns of 0 to 4 (four non-default bins
    each; two or more non-zero in about a third of the rows) in one bundle
    of 4 width + 1 bins, past 256 (16-bit).  Some zeros are -0.0."""
    from lightgbm_torch.binning import BinMapper

    rs = np.random.RandomState(seed + 7)

    def rows(k):
        X = np.zeros((k, 1 + 2 * width))
        X[:, 0] = rs.randn(k)
        X[rs.rand(k) < 0.1, 0] = np.nan
        at = np.arange(k)
        w = 1.0 / np.arange(1, width + 1)
        X[at, 1 + rs.choice(width, k, p=w / w.sum())] = 1.0
        for frac in (0.1, 0.02):
            pick = at[rs.rand(k) < frac]
            X[pick, 1 + rs.randint(0, width, len(pick))] = 1.0
        for frac in (0.6, 0.3, 0.1):
            pick = at[rs.rand(k) < frac]
            X[pick, 1 + width + rs.randint(0, width, len(pick))] = \
                rs.randint(1, 5, len(pick))
        neg = (X == 0) & (rs.rand(*X.shape) < 0.05)
        X[neg] = -0.0
        return X

    sample = rows(40_000)
    mappers = [BinMapper.find_numerical(sample[:, 0], 63, 3, True, False)]
    mappers += [BinMapper.find_numerical(sample[:, f], 15, 3, True, False)
                for f in range(1, 1 + 2 * width)]
    groups = [[0], list(range(1, 1 + width)),
              list(range(1 + width, 1 + 2 * width))]
    return mappers, groups, rows(n)


# (label, rows, bundles of bin_bundle_data (1: one-hot, 2: both), transpose,
# rows a bin_matrix chunk or None for one chunk)
BIN_BUNDLES = (
    ("bundle_b8_rows", 100_003, 1, False, None),
    ("bundle_b8_transposed", 100_003, 1, True, None),
    ("bundle_b16_rows", 100_003, 2, False, 33_331),
    ("bundle_b16_transposed", 100_003, 2, True, 33_331),
)


def bin_adversarial_cases(seed):
    """(label, rows, mappers, groups, sentinel features, transpose, chunk
    rows) of phase bin_adversarial: ``BIN_ADVERSARIAL``'s cases, the
    Flight-Delay-shaped bundles of ``BIN_BUNDLES`` (several non-default
    features a row; 16-bit ones uploaded in chunks, so that a launch has
    row0 > 0), and rows wider than a block's ring (read from global
    memory): 30 000 features, both bundles first, transposed; 8000, the
    one-hot bundle first, as rows."""
    mappers, groups, X = bin_adversarial_data(seed, 1_000_003)
    for label, n, feats, sentinel, transpose in BIN_ADVERSARIAL:
        # the chosen features, renumbered; their groups as they were
        where = {f: j for j, f in enumerate(feats)}
        gs = [[where[f] for f in g if f in where] for g in groups]
        yield (label, np.ascontiguousarray(X[:n, list(feats)]),
               [mappers[f] for f in feats], [g for g in gs if g],
               [where[f] for f in sentinel], transpose, None)
    del X
    bm, bg, BX = bin_bundle_data(seed, 100_003)
    width = len(bg[1])
    for label, n, bundles, transpose, chunk in BIN_BUNDLES:
        k = 1 + bundles * width
        yield (label, np.ascontiguousarray(BX[:n, :k]), bm[:k],
               bg[:1 + bundles], [], transpose, chunk)
    rs = np.random.RandomState(seed + 1)
    for label, n, F, k, transpose in (
            ("wide_rows_unstaged", 2000, 30_000, 1 + 2 * width, True),
            ("wide_rows_unstaged_b8", 2000, 8000, 1 + width, False)):
        Xc = rs.randn(n, F)
        Xc[rs.rand(n, F) < 0.01] = np.nan
        Xc[:, :k] = BX[:n, :k]
        gs = [g for g in bg if g[-1] < k] + [[f] for f in range(k, F)]
        yield (label, Xc, bm[:k] + [mappers[0]] * (F - k), gs, [],
               transpose, None)


def phase_bin_adversarial(seed):
    """bin_rows on ``bin_adversarial_cases``: each output held byte-equal
    to its plain version on the card and to the host
    (``construct_binned``, or for the predict form the host's old sentinel
    re-bin, ``host_predict_bins``), both layouts and widths, staged and
    unstaged, the tables in shared and in global memory, a ragged last
    tile.  Outside any main path's launch counts.  Returns the largest
    difference."""
    import torch
    from lightgbm_torch.binning import construct_binned, device_group_order
    from lightgbm_torch.kernels import bin_rows as br

    dev = torch.device("cuda")
    cases, err = {}, 0.0
    chunk_bytes = br.CHUNK_BYTES
    for label, Xc, ms, gs, sentinel, transpose, chunk in \
            bin_adversarial_cases(seed):
        n, F = Xc.shape
        gs = device_group_order(gs, ms)
        tables = br.bin_tables(ms, gs, dev, sentinel=sentinel)
        if chunk:
            br.CHUNK_BYTES = chunk * 8 * F
        try:
            with BinCapture() as cap, np.errstate(invalid="ignore"):
                out = br.bin_matrix(Xc, tables, transpose=transpose)
            torch.cuda.synchronize()
        finally:
            br.CHUNK_BYTES = chunk_bytes
        host = (host_predict_bins(Xc, ms, gs, sentinel) if sentinel else
                construct_binned(Xc, ms, gs).bins)
        launches, diff = replay_bin_rows(cap, host)
        err = max(err, diff)
        plan = br.launch_plan(cap.calls[0][0], tables)
        cases[label] = {"rows": n, "features": F, "groups": len(gs),
                        "sentinel": list(sentinel), "transpose": transpose,
                        "out_bytes": tables.out_bytes,
                        "plan": plan._asdict(),
                        "row0": [c[3] for c in cap.calls],
                        "ragged_last_tile": bool(
                            cap.calls[-1][0].shape[0] % plan.tile_rows),
                        "launches": launches, "max_abs_err": diff}
        del out, cap
    staged = [c for c in cases.values() if c["plan"]["staged"]]
    unstaged = [c for c in cases.values() if not c["plan"]["staged"]]
    seen = {(c["transpose"], c["out_bytes"]) for c in staged}
    if not (len(seen) == 4
            and {c["transpose"] for c in unstaged} == {False, True}
            and {c["out_bytes"] for c in unstaged} == {1, 2}
            and any(c["plan"]["table_bytes"] for c in staged)
            and any(not c["plan"]["table_bytes"] for c in staged)
            and any(c["ragged_last_tile"] for c in staged)
            and any(max(c["row0"]) > 0 for c in staged)):
        raise RuntimeError(f"bin_rows' cases missed a form: staged "
                           f"(layout, width) {sorted(seen)}")
    emit({"phase": "bin_adversarial", "cases": cases,
          "all_byte_equal": True, "max_abs_err": err})
    return {"bin_rows": err}


def phase_small(seed, tmp):
    """Mixed features, binary and 3-class, with and without early stop, and
    a zero-as-missing Dataset."""
    import lightgbm_torch as lt
    from lightgbm_torch.basic import _host_predict

    n = 30_000
    X, y = make_mixed(n, seed)
    Xt = adversarial_categories(make_mixed(n, seed + 1)[0], 2, seed + 2)
    rs = np.random.RandomState(seed + 3)
    results = []
    # max_bin 63 keeps the EFB bundle within the uint8 bins the kernel reads
    cases = [("binary", 1, {"max_bin": 63}, None),
             ("binary_es", 1, {"max_bin": 63}, (5, 1.0)),
             ("multiclass", 3, {"max_bin": 63}, None),
             ("zero_as_missing", 1, {"max_bin": 63, "zero_as_missing": True},
              None)]
    for name, k, extra, es in cases:
        params = {"objective": "binary" if k == 1 else "multiclass",
                  "num_leaves": 31, "verbosity": -1, **extra}
        if k > 1:
            params["num_class"] = k
        ds_kw = {"categorical_feature": [2], "params": dict(extra)}
        mappers = lt.Dataset(X, label=y, **ds_kw).bin_mappers()
        trees = [random_tree(rs, mappers, 31) for _ in range(15 * k)]
        label = y if k > 1 else (y > 0).astype(np.float64)
        bst = serve(X, label, trees, k, params, ds_kw, tmp)
        groups = bst.engine.train_data.binned.group_features
        if not any(len(g) > 1 for g in groups):
            raise RuntimeError("the mixed data must bundle features (EFB)")
        check_kernel_against_plain(bst, Xt, es)
        kw = ({"pred_early_stop": True, "pred_early_stop_freq": es[0],
               "pred_early_stop_margin": es[1]} if es else {})
        pred = bst.predict(Xt, raw_score=True, **kw)
        use, _, _, _ = bst._resolve_tree_slice(0, None)
        host = _host_predict(Xt, use, k, bool(es), *(es or (10, 10.0)))
        np.testing.assert_allclose(pred, host, rtol=RTOL, atol=ATOL)
        if es:
            full = bst.predict(Xt, raw_score=True)
            if not np.abs(full - pred).max() > 1e-6:
                raise RuntimeError("early stop did not bite")
        results.append({"case": name, "k": k, "rows": len(Xt),
                        "trees": len(trees),
                        "max_abs_err_vs_host": float(np.abs(pred - host).max()),
                        "kernel_equals_plain": True})
    emit({"phase": "small", "cases": results})


def phase_full(seed, rows, n_trees, num_leaves, tmp, smi, sub_rows=20_000):
    """The north-star shape through the public entry points."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.basic import _host_predict, _to_2d_float
    from lightgbm_torch.kernels import predict as tpk
    from lightgbm_torch.kernels.layout import pack_bins_T

    t0 = time.perf_counter()
    X, y = make_higgs_like(rows, 28, seed)
    Xs, ys = make_higgs_like(rows, 28, seed + 1)
    params = {"objective": "binary", "num_leaves": num_leaves, "max_bin": 63,
              "verbosity": -1}
    ds = lt.Dataset(X, label=y, params=dict(params))
    t_data = time.perf_counter() - t0
    construct_s, _, ds_launches, ds_err = construct_replayed(ds, X)
    t_data += construct_s
    rs = np.random.RandomState(seed + 2)
    trees = [random_tree(rs, ds.bin_mappers(), num_leaves)
             for _ in range(n_trees)]
    path = Path(tmp) / "full.txt"
    write_model(path, trees, 28, 1)
    t0 = time.perf_counter()
    bst = lt.train(params, ds, 0, init_model=str(path))
    torch.cuda.synchronize()
    t_train0 = time.perf_counter() - t0

    bst.predict(Xs[:sub_rows])             # warm the host side once
    kernels.reset_launch_counts()
    pred, t_predict, bin_cap, bin_replayed, bin_err = predict_replayed(
        bst, Xs, raw_score=True)
    launches = kernels.launch_counts()
    if pred.shape != (rows,) or not np.isfinite(pred).all():
        raise RuntimeError("predict returned a wrong shape or non-finite "
                           "scores")
    if launches["predict_stream"] == 0 or launches["bin_rows"] == 0:
        raise RuntimeError(f"predict launched {launches}")

    inp, (got,), err = check_kernel_against_plain(bst, Xs)
    if not np.array_equal(got.cpu().numpy().astype(np.float64), pred):
        raise RuntimeError("predict differs from the kernel's output")
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    t0 = time.perf_counter()
    host = _host_predict(Xs[:sub_rows].astype(np.float64), use, 1, False, 10,
                         10.0)
    t_host = time.perf_counter() - t0
    np.testing.assert_allclose(pred[:sub_rows], host, rtol=RTOL, atol=ATOL)

    # stages of the device path as predict runs them (its float64 copy of
    # the rows made first, as predict makes it), and the host binning and
    # upload of the bins that predict ran before rows were binned on the
    # card, on the same rows
    breakdown = {}
    bst._device_predict_inputs(_to_2d_float(Xs)[0], use, 1, None,
                               times=breakdown)
    tb = bst.engine.train_data.binned
    t0 = time.perf_counter()
    pack_bins_T(host_predict_bins(Xs, tb.bin_mappers, tb.group_features,
                                  split_cat_features(use)), torch.device(
                                      "cuda"))
    torch.cuda.synchronize()
    host_binning_s = time.perf_counter() - t0
    bin_time = time_bin_rows(bin_cap)
    del bin_cap
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    ms = device_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv,
                                                   words, maxd), reps=5)
    plain_ms = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    # the work this data needs: node visits, the operations of each visit
    # from its node's flags plus one add per row and tree, the record bytes
    # the visits read, and the bytes the launch copies from L2 into shared
    # memory under its plan (every tile: each tree's walk records and leaf
    # values, and its rows' bins)
    visits = path_sum(inp, use, lambda r: np.ones(len(r)), maxd)
    n_bytes, n_ops = k1_work(inp, use, maxd, rows)
    record_bytes = path_sum(inp, use, walk_record_bytes, maxd)
    G, T, L = inp.bins_T.shape[0], lv.shape[0], lv.shape[1]
    plan = tpk.predict_plan(rows, G, L, T)
    depth_tab = np.zeros(tuple(lv.shape), np.float32)
    for i, t in enumerate(use):
        sums = tpk.leaf_path_sums(t)
        depth_tab[i, :len(sums)] = sums
    lane_eff = walk_lane_efficiency(inp.bins_T, nodes, torch.as_tensor(
        depth_tab, device=lv.device), words, maxd, plan.rows_per_tile)
    stage_bytes = (plan.tiles * T * tpk.STAGE_NODE_BYTES * L
                   if plan.trees_per_stage else 0)
    stage_bytes += G * rows if plan.bins_stride else 0
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CORE_OPS_PER_S * 1e3
    kernel = {"name": "predict_stream", "route": "cuda",
              "source": KERNEL_SOURCES["predict_stream"],
              "replaces": KERNEL_REPLACES["predict_stream"],
              "launches": launches["predict_stream"],
              "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms,
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "library_ms": None}
    emit({"phase": "full", "card": smi, "rows": rows, "features": 28, "trees": n_trees,
          "num_leaves": num_leaves, "max_depth": maxd,
          "dataset_s": t_data, "construct_s": construct_s,
          "train0_s": t_train0, "predict_s": t_predict,
          "predict_rows_per_s": rows / t_predict,
          "kernel_ms": ms, "kernel_rows_per_s": rows / (ms / 1e3),
          "plain_ms": plain_ms, "host_walk_s": t_host,
          "host_walk_rows": sub_rows,
          "max_abs_err_vs_host": float(np.abs(pred[:sub_rows] - host).max()),
          "predict_breakdown_s": breakdown,
          "host_binning_upload_s": host_binning_s,
          "bin_rows": {**bin_time, "launches": launches["bin_rows"],
                       "replayed": bin_replayed, "max_abs_err": bin_err,
                       "dataset_launches_replayed": ds_launches},
          "node_visits": visits,
          "bytes": n_bytes, "ops": n_ops, "ops_per_visit": n_ops / visits,
          "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
          "plan": plan._asdict(), "walk_lane_efficiency": lane_eff,
          "record_bytes_read": record_bytes,
          "record_bytes_per_visit": record_bytes / visits,
          "stage_copy_bytes": stage_bytes,
          "stage_copy_gb_per_s": stage_bytes / (ms / 1e3) / 1e9})
    binner = {"name": "bin_rows", "route": "cuda",
              "source": KERNEL_SOURCES["bin_rows"],
              "replaces": KERNEL_REPLACES["bin_rows"],
              "launches": launches["bin_rows"],
              "max_abs_err": max(bin_err, ds_err),
              "ms": bin_time["ms"], "plain_ms": bin_time["plain_ms"],
              "bound_ms": bin_time["bound_ms"],
              "bound_by": bin_time["bound_by"], "library_ms": None,
              "plan": bin_time["plan"]}
    return kernel, binner, ds, Xs, ys, bst


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def make_train_small(n, seed):
    """The numeric columns of make_mixed (NaN, zero-heavy, the EFB-bundled
    pair, dense noise) and a binary label with signal in several of them."""
    X, _ = make_mixed(n, seed)
    X = X[:, [0, 1, 3, 4, 5, 6]]
    rs = np.random.RandomState(seed + 7)
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-train_small_logit(X)))).astype(
        np.float64)
    return X, y


def train_small_logit(X):
    """make_train_small's logit of its rows."""
    return (np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1] + 2.0 * X[:, 2]
            - 1.5 * X[:, 3] + 0.7 * X[:, 4] * X[:, 5])


def dyadic_fobj(score, ds):
    """Custom gradients on a 1/64 grid with unit hessians: every sum of them
    is exact in float32, so any correct formulation grows the same trees."""
    g = np.clip(np.round(64.0 * (score - ds.get_label())) / 64.0,
                -127 / 64, 127 / 64)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


def model_trees_text(bst, **kw):
    """The model text up to the end of its trees (the parameter block names
    the device, the feature importances count all trees)."""
    return bst.model_to_string(**kw).split("end of trees")[0]


def tree_structure(t):
    return (t.num_leaves, t.split_feature.tolist(), t.threshold.tolist(),
            t.decision_type.tolist(), t.left_child.tolist(),
            t.right_child.tolist())


def owned(args):
    """The arguments with every tensor copied: the fused iteration's
    buffers (its gradients, compacted rows and shift tables) are written
    again by the next iteration."""
    import torch
    return tuple(a.clone() if isinstance(a, torch.Tensor)
                 else tuple(x.clone() if isinstance(x, torch.Tensor) else x
                            for x in a) if isinstance(a, tuple) else a
                 for a in args)


class Capture:
    """Records every K2 (both forms), K3, K4, K5, K6/K7 and K8 call of the
    training loop (inputs and outputs) while active, by wrapping the
    dispatchers that ops/grow.py, ops/histogram.py and models/gbdt.py call,
    and the inputs of every percentile renewal (``renew``: the score before
    the tree, every row's leaf, ``num_leaves`` and the tree's in-bag mask).
    The calls still go through the kernels' wrappers and are counted
    there.  While active, the fused iteration runs its steps without CUDA
    graphs (``utils.graphs.uncaptured``): the same code and shapes its
    graphs hold, through the wrappers this watches."""

    def __init__(self):
        self.k2, self.k3, self.k4, self.k5, self.k67 = [], [], [], [], []
        self.k8, self.k2i, self.renew = [], [], []

    def __enter__(self):
        from lightgbm_torch.kernels import hist_sorted, hist_wide, scatter_hist
        from lightgbm_torch.models import gbdt
        from lightgbm_torch.ops import grow
        from lightgbm_torch.utils import graphs
        self._uncaptured = graphs.uncaptured()
        self._uncaptured.__enter__()
        self._orig = (grow.route_and_hist, grow.route_replay,
                      gbdt.leaf_gather, scatter_hist.scatter_hist,
                      hist_sorted.hist_sorted, hist_wide.hist_wide,
                      grow.route_and_hist_int)
        (k2_call, k3_call, k4_call, k5_call, k67_call, k8_call,
         k2i_call) = self._orig

        def k2(bins_T, leaf_id, tabs, words, grad, hess, cnt, *args):
            out = k2_call(bins_T, leaf_id, tabs, words, grad, hess, cnt,
                          *args)
            self.k2.append((owned((bins_T, leaf_id, tabs, words, grad, hess,
                                   cnt) + tuple(args)), out))
            return out

        def k2i(bins_T, leaf_id, tabs, words, *args):
            out = k2i_call(bins_T, leaf_id, tabs, words, *args)
            self.k2i.append((owned((bins_T, leaf_id, tabs, words)
                                   + tuple(args)), out))
            return out

        def k3(bins_T, tabs):
            out = k3_call(bins_T, tabs)
            self.k3.append(((bins_T, tabs.clone()), out))
            return out

        def k4(leaf_id, values):
            out = k4_call(leaf_id, values)
            self.k4.append(((leaf_id.clone(), values.clone()), out))
            return out

        def k5(bins_T, slot, *args):
            out = k5_call(bins_T, slot, *args)
            self.k5.append(((bins_T, slot.clone()) + args, out))
            return out

        def k67(bins, gather_idx, scalars, *args):
            out = k67_call(bins, gather_idx, scalars, *args)
            self.k67.append(((bins, gather_idx.clone(), scalars.clone())
                             + args, out))
            return out

        def k8(bins_T, slot, *args):
            out = k8_call(bins_T, slot, *args)
            self.k8.append(((bins_T, slot.clone()) + args, out))
            return out

        self._renew_orig = renew_call = gbdt.GBDT._renew_leaves_percentile

        def renew(eng, arrays, leaf_id, mask):
            n = eng.num_data
            self.renew.append((eng.score[:n].clone(), leaf_id[:n].clone(),
                               eng.grow_params.num_leaves,
                               mask[:n].clone()))
            return renew_call(eng, arrays, leaf_id, mask)

        (grow.route_and_hist, grow.route_replay, gbdt.leaf_gather,
         scatter_hist.scatter_hist, hist_sorted.hist_sorted,
         hist_wide.hist_wide, grow.route_and_hist_int) = (
            k2, k3, k4, k5, k67, k8, k2i)
        gbdt.GBDT._renew_leaves_percentile = renew
        return self

    def __exit__(self, *exc):
        from lightgbm_torch.kernels import hist_sorted, hist_wide, scatter_hist
        from lightgbm_torch.models import gbdt
        from lightgbm_torch.ops import grow
        (grow.route_and_hist, grow.route_replay, gbdt.leaf_gather,
         scatter_hist.scatter_hist, hist_sorted.hist_sorted,
         hist_wide.hist_wide, grow.route_and_hist_int) = self._orig
        gbdt.GBDT._renew_leaves_percentile = self._renew_orig
        self._uncaptured.__exit__(*exc)


def max_abs_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) \
        if a.numel() else 0.0


def k2_route_chain(bins_T, tabs):
    """Every row's leaf after the (R, L, 16) records, as the unfused path
    gets it: one route-only K2 launch per round over all rows from leaf 0
    (launched for the comparison, after the main path's counts were
    read)."""
    import torch
    from lightgbm_torch.kernels import route_hist as rh

    G, n = bins_T.shape
    R, L = tabs.shape[0], tabs.shape[1]
    dev = bins_T.device
    zeros = torch.zeros((1, n), dtype=torch.float32, device=dev)
    words = torch.zeros((1, L, 8), dtype=torch.int32, device=dev)
    lid = torch.zeros((1, n), dtype=torch.int32, device=dev)
    for r in range(R):
        lid, _, _ = rh.route_and_hist_cuda(bins_T, lid, tabs[r][None]
                                           .contiguous(), words, zeros,
                                           zeros, zeros[0], L, 256, (0,),
                                           False)
    return lid[0]


def sorted_kernel(max_bins) -> str:
    """The kernel ``hist_sorted`` launches at this Bmax: K6 or K7."""
    from lightgbm_torch.kernels.hist_sorted import DIRECT_MAX_BINS
    return "hist_direct" if max_bins <= DIRECT_MAX_BINS else "hist_nibble"


def replay_against_plain(cap):
    """Every captured launch through the plain version on the card, and
    each K3 launch also against the chain of route-only K2 launches it
    fuses; raises unless leaf ids, counts, histograms and gathers are equal
    bit for bit.  Returns the launches replayed and the largest difference
    of each kernel's outputs from its plain version's, K2's launches over
    K > 1 classes (multiclass) apart as ``route_and_hist_k``, its int form
    as ``route_and_hist_int`` (over K > 1 classes ``route_and_hist_int_k``)."""
    import torch
    from lightgbm_torch.kernels import hist_sorted as hs, hist_wide as hw
    from lightgbm_torch.kernels import leaf_gather as lg, route_hist as rh
    from lightgbm_torch.kernels import route_replay as rr
    from lightgbm_torch.kernels import scatter_hist as sh

    err = {"route_and_hist": 0.0, "route_and_hist_k": 0.0,
           "route_and_hist_int": 0.0, "route_and_hist_int_k": 0.0,
           "route_replay": 0.0, "leaf_gather": 0.0, "scatter_hist": 0.0,
           "hist_direct": 0.0, "hist_nibble": 0.0, "hist_wide": 0.0}
    replayed = {k: 0 for k in err}
    hist_calls = ([("scatter_hist", a, o, sh.scatter_hist_plain)
                   for a, o in cap.k5]
                  + [(sorted_kernel(a[7]), a, o, hs.hist_sorted_plain)
                     for a, o in cap.k67]
                  + [("hist_wide", a, o, hw.hist_wide_plain)
                     for a, o in cap.k8])
    for name, args, out, plain in hist_calls:
        want = plain(*args)
        diff = max_abs_diff(out, want)
        err[name] = max(err[name], diff)
        replayed[name] += 1
        if not torch.equal(out, want):
            raise RuntimeError(f"{name} differs from its plain version "
                               f"(max abs {diff})")
    for (bins_T, tabs), out in cap.k3:
        want = rr.route_replay_plain(bins_T, tabs)
        chain = k2_route_chain(bins_T, tabs)
        diff = max(max_abs_diff(out, want), max_abs_diff(out, chain))
        err["route_replay"] = max(err["route_replay"], diff)
        if not (torch.equal(out, want) and torch.equal(out, chain)):
            raise RuntimeError(f"route_replay differs from its plain version "
                               f"or the K2 route chain (max abs {diff})")
    for args, (new_leaf, hist, counts) in cap.k2:
        name = "route_and_hist_k" if args[1].shape[0] > 1 \
            else "route_and_hist"
        replayed[name] += 1
        p_leaf, p_hist, p_counts = rh.route_and_hist_plain(*args)
        diffs = [max_abs_diff(new_leaf, p_leaf), max_abs_diff(counts, p_counts)]
        if hist is not None:
            diffs.append(max_abs_diff(hist, p_hist))
        err[name] = max(err[name], *diffs)
        same = (torch.equal(new_leaf, p_leaf) and torch.equal(counts, p_counts)
                and (hist is None or torch.equal(hist, p_hist)))
        if not same:
            raise RuntimeError(f"route_and_hist differs from its plain "
                               f"version (max abs {max(diffs)})")
    for args, (new_leaf, hist, counts) in cap.k2i:
        name = "route_and_hist_int_k" if args[1].shape[0] > 1 \
            else "route_and_hist_int"
        replayed[name] += 1
        p_leaf, p_hist, p_counts = rh.route_and_hist_int_plain(*args)
        diffs = [max_abs_diff(new_leaf, p_leaf), max_abs_diff(counts, p_counts)]
        if hist is not None:
            diffs.append(max_abs_diff(hist, p_hist))
        err[name] = max(err[name], *diffs)
        same = (torch.equal(new_leaf, p_leaf) and torch.equal(counts, p_counts)
                and (hist is None or torch.equal(hist, p_hist)))
        if not same:
            raise RuntimeError(f"route_and_hist_int differs from its plain "
                               f"version (max abs {max(diffs)})")
    for (leaf_id, values), out in cap.k4:
        want = lg.leaf_gather_plain(leaf_id, values)
        diff = max_abs_diff(out, want)
        err["leaf_gather"] = max(err["leaf_gather"], diff)
        if not torch.equal(out, want):
            raise RuntimeError(f"leaf_gather differs from its plain version "
                               f"(max abs {diff})")
    replayed.update({"route_replay": len(cap.k3), "leaf_gather": len(cap.k4)})
    return replayed, err


def phase_train_small(seed, n=20_000, iters=5, num_leaves=127):
    """Training on both devices: a dyadic custom-gradient run must give
    byte-identical model text; a binary run must grow the same first tree
    and scores within atol 2e-4; every K2 and K4 launch of the card's binary
    run must equal its plain version on the card.  num_leaves 127 makes the
    split budget 64, so the main loop ends in the route-only sprint round.
    Dyadic runs under scatter and pallas at max_bin 63 and 255 must give one
    text per max_bin on both devices, every card launch of K5, K6 and K7
    equal to its plain version."""
    import torch
    import lightgbm_torch as lt

    X, y = make_train_small(n, seed)
    base = {"num_leaves": num_leaves, "max_splits_per_round": 64,
            "max_bin": 63, "verbosity": -1}
    texts, boosters = {}, {}
    for dev in ("cpu", "cuda"):
        p = {**base, "objective": "none", "device_type": dev}
        bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
        for _ in range(iters):
            bst.update(fobj=dyadic_fobj)
        texts[dev] = model_trees_text(bst)
    groups = bst.engine.train_data.binned.group_features
    if not any(len(g) > 1 for g in groups):
        raise RuntimeError("the training data must bundle features (EFB)")
    if texts["cpu"] != texts["cuda"]:
        raise RuntimeError("dyadic training differs between CPU and card")
    nl = [t.num_leaves for t in bst.engine.models]
    cap = Capture()
    for dev in ("cpu", "cuda"):
        p = {**base, "objective": "binary", "device_type": dev}
        ds = lt.Dataset(X, label=y, params=p)
        if dev == "cuda":
            with cap:
                boosters[dev] = lt.train(p, ds, iters)
        else:
            boosters[dev] = lt.train(p, ds, iters)
    cpu_t, gpu_t = (boosters[d].engine.models for d in ("cpu", "cuda"))
    if tree_structure(cpu_t[0]) != tree_structure(gpu_t[0]):
        raise RuntimeError("binary: the first tree differs between devices")
    differ = sum(tree_structure(a) != tree_structure(b)
                 for a, b in zip(cpu_t, gpu_t))
    s_cpu = boosters["cpu"].engine.score[:n].numpy()
    s_gpu = boosters["cuda"].engine.score[:n].cpu().numpy()
    gap = float(np.abs(s_cpu - s_gpu).max())
    if not (gap <= 2e-4 and np.isfinite(s_gpu).all()):
        raise RuntimeError(f"binary: raw scores differ by {gap}")
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    # the default max_bin, 255: a group's 64 slots outgrow one block's
    # shared memory, so K2 splits the slots over blocks (the EFB pair is
    # left out: bundled at 255 bins it would need uint16 bins)
    p = {**base, "max_bin": 255, "objective": "binary", "device_type": "cuda"}
    Xw = X[:, [0, 1, 2, 4, 5]]
    cap255 = Capture()
    with cap255:
        lt.train(p, lt.Dataset(Xw, label=y, params=p), 2)
    replayed_255, err_255 = replay_against_plain(cap255)
    # the non-stream backends (K5, K6, K7): dyadic runs on both devices at
    # max_bin 63 and 255, all four texts of a max_bin identical, every
    # launch of the card's runs replayed
    cap_nb = Capture()
    nb_leaves = {}
    for mb, data, n_iter in ((63, X, iters), (255, Xw, 2)):
        nb_texts = set()
        for hb in ("scatter", "pallas"):
            for dev in ("cpu", "cuda"):
                p = {**base, "max_bin": mb, "objective": "none",
                     "hist_backend": hb, "device_type": dev}
                bst = lt.Booster(p, lt.Dataset(data, label=y, params=p))
                with (cap_nb if dev == "cuda"
                      else contextlib.nullcontext()):
                    for _ in range(n_iter):
                        bst.update(fobj=dyadic_fobj)
                nb_texts.add(model_trees_text(bst))
        if len(nb_texts) != 1:
            raise RuntimeError(f"max_bin {mb}: scatter and pallas training "
                               f"differ between backends or devices")
        nb_leaves[mb] = [t.num_leaves for t in bst.engine.models]
    torch.cuda.synchronize()
    replayed_nb, err_nb = replay_against_plain(cap_nb)
    if not all(replayed_nb[k] for k in HIST_KERNELS):
        raise RuntimeError(f"the backends' runs replayed {replayed_nb}")
    err = {k: max(v, err_255[k], err_nb[k]) for k, v in err.items()}
    # the growth constraints on dyadic gradients: the CPU's stream text
    # equal to the card's under stream, scatter and pallas (split budget
    # 8: one schedule for the three), and at budget 64 (the sprint) under
    # stream; every card launch replayed
    cap_c = Capture()
    constrained = {}
    for name, extra in CONSTRAINT_ARMS.items():
        runs = [("cpu", "stream"), ("cuda", "stream")]
        if name != "all_sprint":
            runs += [("cuda", "scatter"), ("cuda", "pallas")]
        c_texts = []
        for dev, hb in runs:
            p = {**base, "num_leaves": 31, "max_splits_per_round": 8,
                 **extra, "objective": "none", "hist_backend": hb,
                 "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
            with (cap_c if dev == "cuda" else contextlib.nullcontext()):
                for _ in range(3):
                    bst.update(fobj=dyadic_fobj)
            c_texts.append(model_trees_text(bst))
        if any(t != c_texts[0] for t in c_texts):
            raise RuntimeError(f"constrained training ({name}) differs "
                               f"{[t == c_texts[0] for t in c_texts]}")
        constrained[name] = {"runs": [f"{d} {hb}" for d, hb in runs],
                             "leaves_per_tree": [t.num_leaves for t in
                                                 bst.engine.models]}
    torch.cuda.synchronize()
    replayed_c, err_c = replay_against_plain(cap_c)
    if not all(replayed_c[k] for k in ("route_and_hist", "leaf_gather",
                                       "scatter_hist", "hist_direct")):
        raise RuntimeError(f"the constrained runs replayed {replayed_c}")
    err = {k: max(v, err_c[k]) for k, v in err.items()}
    # the monotone methods and the per-node draws, K = 1 and K = 3, eager
    # and fused, every card launch replayed
    t0 = time.perf_counter()
    methods, replayed_m, err_m = method_arms_small(X, y, base)
    methods_wall_s = time.perf_counter() - t0
    err = {k: max(v, err_m[k]) for k, v in err.items()}
    # CEGB, forced splits and linear trees, the same runs
    t0 = time.perf_counter()
    extras, replayed_x, err_x = extra_arms_small(X, y, base)
    extras_wall_s = time.perf_counter() - t0
    err = {k: max(v, err_x[k]) for k, v in err.items()}
    # the fused iteration on the card against the eager one on the CPU
    fused_cpu = {name: fused_against_cpu(X, y, {**base, **extra}, iters)
                 for name, extra in (("l2", {}),
                                     ("l2_max_depth", {"max_depth": 5}))}
    emit({"phase": "train_small", "rows": n, "iterations": iters,
          "num_leaves": num_leaves, "dyadic_leaves_per_tree": nl,
          "dyadic_text_identical": True, "binary_first_tree_identical": True,
          "binary_trees_differing": differ, "binary_max_score_gap": gap,
          "replayed_launches": replayed,
          "replayed_launches_max_bin_255": replayed_255,
          "backends_text_identical": True,
          "backends_leaves_per_tree": nb_leaves,
          "replayed_launches_backends": replayed_nb,
          "constrained": constrained,
          "constrained_text_identical_cpu_card_backends": True,
          "replayed_launches_constrained": replayed_c,
          "methods": methods, "methods_wall_s": methods_wall_s,
          "replayed_launches_methods": replayed_m,
          "extras": extras, "extras_wall_s": extras_wall_s,
          "replayed_launches_extras": replayed_x,
          "replay_max_abs_err": err,
          "fused_card_text_equals_eager_cpu": fused_cpu})
    return err


# make_train_small's growth constraints, one arm each and all together
# (at split budget 8), and all together at budget 64 (127 leaves: the full
# rounds and the sprint): the monotone signs of its logit's additive terms,
# monotone_penalty, interaction groups that keep the x4 * x5 term together
# and list every feature, path_smooth
_SMALL_MONO = [1, 1, 1, -1, 0, 0]
_SMALL_GROUPS = [[0, 1, 2, 3], [4, 5]]
_SMALL_EVERY = {"monotone_constraints": _SMALL_MONO, "monotone_penalty": 0.5,
                "interaction_constraints": _SMALL_GROUPS, "path_smooth": 1.0}
CONSTRAINT_ARMS = {
    "monotone": {"monotone_constraints": _SMALL_MONO},
    "monotone_penalty": {"monotone_constraints": _SMALL_MONO,
                         "monotone_penalty": 1.5},
    "interaction": {"interaction_constraints": _SMALL_GROUPS},
    "path_smooth": {"path_smooth": 2.0},
    "all": _SMALL_EVERY,
    "all_sprint": {**_SMALL_EVERY, "num_leaves": 127,
                   "max_splits_per_round": 64},
}


# the intermediate and advanced monotone methods, by-node sampling and
# extra trees, one arm each and all together with the interaction groups
# and path_smooth
METHOD_ARMS = {
    "intermediate": {"monotone_constraints": _SMALL_MONO,
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": _SMALL_MONO,
                 "monotone_constraints_method": "advanced"},
    "bynode": {"feature_fraction_bynode": 0.5},
    "extra_trees": {"extra_trees": True},
    "every": {**_SMALL_EVERY, "monotone_constraints_method": "advanced",
              "feature_fraction_bynode": 0.5, "extra_trees": True},
}


def method_arms_small(X, y, base, iters=2, num_leaves=31):
    """phase_train_small's arms of ``METHOD_ARMS`` on dyadic gradients
    (split budget 8; the monotone methods split one leaf a round, on 15
    leaves): for
    each, the CPU's stream text equal to the card's under stream, scatter
    and pallas, one class (``iters`` trees) and K = 3 (one iteration, the
    class trees grown one at a time), and the fused one-class iteration on
    the card (its graphs replayed) equal to the eager CPU on L2 regression;
    then every mode at max_bin 255 under pallas (K7) and quantized under
    stream (K2's int form), CPU == card.  Every card launch of K2 (both
    forms), K4, K5, K6 and K7 is replayed through its plain version.
    Returns (per-arm results, launches replayed, largest differences)."""
    import torch
    import lightgbm_torch as lt

    rs = np.random.RandomState(3)
    logits = np.stack([np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1],
                       2.0 * X[:, 2] - 1.5 * X[:, 3], X[:, 4] * X[:, 5]], 1)
    y3 = np.argmax(logits + rs.randn(len(y), 3), axis=1).astype(np.float64)
    runs = [("cpu", "stream"), ("cuda", "stream"), ("cuda", "scatter"),
            ("cuda", "pallas")]
    cap, out = Capture(), {}

    def texts_of(data, label, extra, fobj, n_iter, runs):
        texts = []
        for dev, hb in runs:
            p = {**base, "num_leaves": num_leaves, "max_splits_per_round": 8,
                 **extra, "hist_backend": hb, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(data, label=label, params=p))
            with (cap if dev == "cuda" else contextlib.nullcontext()):
                for _ in range(n_iter):
                    bst.update(fobj=fobj)
            texts.append(model_trees_text(bst))
        if any(t != texts[0] for t in texts):
            raise RuntimeError(f"{extra}: CPU and card text differ "
                               f"{[t == texts[0] for t in texts]}")
        return [t.num_leaves for t in bst.engine.models]

    for name, extra in METHOD_ARMS.items():
        t0 = time.perf_counter()
        if "monotone_constraints_method" in extra:
            # one split a round: 15 leaves keep the CPU runs short
            extra = {**extra, "num_leaves": 15}
        k1 = texts_of(X, y, {**extra, "objective": "none"}, dyadic_fobj,
                      iters, runs)
        k3 = texts_of(X, y3, {**extra, "objective": "multiclass",
                              "num_class": 3}, dyadic_mc_fobj, 1, runs)
        fused = fused_against_cpu(X, y, {**base, "num_leaves": num_leaves,
                                         "max_splits_per_round": 8, **extra},
                                  iters)
        out[name] = {"leaves_per_tree": k1, "k3_leaves_per_tree": k3,
                     "fused_card_text_equals_eager_cpu": fused,
                     "seconds": time.perf_counter() - t0}
    # max_bin 255 under pallas (K7) without the EFB pair, whose bundle
    # would need 16-bit bins; quantized under stream (K2's int form)
    every = {**METHOD_ARMS["every"], "objective": "none", "num_leaves": 15}
    Xw = X[:, [0, 1, 2, 4, 5]]
    out["every_max_bin_255"] = texts_of(
        Xw, y, {**every, "max_bin": 255,
                "monotone_constraints": [1, 1, 1, 0, 0],
                "interaction_constraints": [[0, 1, 2], [3, 4]]},
        dyadic_fobj, 2, [("cpu", "stream"), ("cuda", "pallas")])
    out["every_quantized"] = texts_of(
        X, y, {**every, "use_quantized_grad": True}, pow2_fobj, iters,
        [("cpu", "stream"), ("cuda", "stream")])
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not all(replayed[k] for k in ("route_and_hist", "route_and_hist_int",
                                     "leaf_gather", "scatter_hist",
                                     "hist_direct", "hist_nibble")):
        raise RuntimeError(f"the method arms replayed {replayed}")
    return out, replayed, err


# the growth extras on make_train_small: CEGB (a split cost, coupled costs
# on two signal columns, lazy costs on the NaN column and a dense one,
# tradeoff 1/2; dyadic, so every cost is exact), a forced tree of two
# levels (NaN column and zero-heavy column, both default sides), linear
# trees, and all three together
_SMALL_CEGB = {"cegb_penalty_split": 2.0 ** -10, "cegb_tradeoff": 0.5,
               "cegb_penalty_feature_coupled": [0.0, 0.0, 4.0, 0.0, 0.0, 8.0],
               "cegb_penalty_feature_lazy": [2.0 ** -8, 0.0, 0.0, 0.0,
                                             2.0 ** -9, 0.0]}
_SMALL_FORCED = {"feature": 2, "threshold": 0.0, "default_left": True,
                 "left": {"feature": 0, "threshold": 0.0},
                 "right": {"feature": 1, "threshold": 0.5,
                           "default_left": True}}
EXTRA_ARMS = {
    "cegb": _SMALL_CEGB,
    "forced": {"forcedsplits_filename": _SMALL_FORCED},
    "linear": {"linear_tree": True},
    "every": {**_SMALL_CEGB, "forcedsplits_filename": _SMALL_FORCED,
              "linear_tree": True, "linear_lambda": 0.5},
}


def extra_arms_small(X, y, base, iters=2, num_leaves=31):
    """phase_train_small's arms of ``EXTRA_ARMS`` on dyadic gradients
    (split budget 8), as ``method_arms_small`` runs its arms: for each, the
    CPU's stream text equal to the card's under stream, scatter and pallas,
    one class (``iters`` trees) and K = 3 (one iteration, the class trees
    grown one at a time); the forced tree fused on the card (its forced
    levels captured rounds) equal to the eager CPU; every mode together at
    max_bin 255 under pallas (K7) and quantized under stream (K2's int
    form), CPU == card.  Every card launch of K2 (both forms), K4, K5, K6
    and K7 is replayed through its plain version.  Returns (per-arm
    results, launches replayed, largest differences)."""
    import torch
    import lightgbm_torch as lt

    rs = np.random.RandomState(5)
    logits = np.stack([np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1],
                       2.0 * X[:, 2] - 1.5 * X[:, 3], X[:, 4] * X[:, 5]], 1)
    y3 = np.argmax(logits + rs.randn(len(y), 3), axis=1).astype(np.float64)
    runs = [("cpu", "stream"), ("cuda", "stream"), ("cuda", "scatter"),
            ("cuda", "pallas")]
    cap, out = Capture(), {}
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "forced.json"
        spec.write_text(json.dumps(_SMALL_FORCED))

        def resolve(extra):
            if "forcedsplits_filename" in extra:
                extra = {**extra, "forcedsplits_filename": str(spec)}
            return extra

        def texts_of(data, label, extra, fobj, n_iter, runs):
            texts = []
            for dev, hb in runs:
                p = {**base, "num_leaves": num_leaves,
                     "max_splits_per_round": 8, **resolve(extra),
                     "hist_backend": hb, "device_type": dev}
                bst = lt.Booster(p, lt.Dataset(data, label=label, params=p))
                with (cap if dev == "cuda" else contextlib.nullcontext()):
                    for _ in range(n_iter):
                        bst.update(fobj=fobj)
                texts.append(model_trees_text(bst))
            if any(t != texts[0] for t in texts):
                raise RuntimeError(f"{extra}: CPU and card text differ "
                                   f"{[t == texts[0] for t in texts]}")
            return [t.num_leaves for t in bst.engine.models]

        for name, extra in EXTRA_ARMS.items():
            t0 = time.perf_counter()
            k1 = texts_of(X, y, {**extra, "objective": "none"}, dyadic_fobj,
                          iters, runs)
            k3 = texts_of(X, y3, {**extra, "objective": "multiclass",
                                  "num_class": 3}, dyadic_mc_fobj, 1,
                          runs[:3])
            out[name] = {"leaves_per_tree": k1, "k3_leaves_per_tree": k3,
                         "seconds": time.perf_counter() - t0}
        out["forced"]["fused_card_text_equals_eager_cpu"] = \
            fused_against_cpu(X, y, {**base, "num_leaves": num_leaves,
                                     "max_splits_per_round": 8,
                                     **resolve(EXTRA_ARMS["forced"])}, iters)
        # max_bin 255 under pallas (K7) without the EFB pair, whose bundle
        # would need 16-bit bins; quantized under stream (K2's int form)
        every = {**EXTRA_ARMS["every"], "objective": "none"}
        Xw = X[:, [0, 1, 2, 4, 5]]
        out["every_max_bin_255"] = texts_of(
            Xw, y, {**every, "max_bin": 255,
                    "cegb_penalty_feature_coupled": [0.0, 0.0, 4.0, 0.0, 8.0],
                    "cegb_penalty_feature_lazy": [2.0 ** -8, 0.0, 0.0,
                                                  2.0 ** -9, 0.0]},
            dyadic_fobj, 2, [("cpu", "stream"), ("cuda", "pallas")])
        out["every_quantized"] = texts_of(
            X, y, {**every, "use_quantized_grad": True}, pow2_fobj, iters,
            [("cpu", "stream"), ("cuda", "stream")])
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not all(replayed[k] for k in ("route_and_hist", "route_and_hist_int",
                                     "leaf_gather", "scatter_hist",
                                     "hist_direct", "hist_nibble")):
        raise RuntimeError(f"the extra arms replayed {replayed}")
    return out, replayed, err


def k2_work(args, out, int_form=False):
    """Bytes and operations one K2 launch needs on these inputs, counted
    from what the rows need, over every class of the launch (``int_form``:
    the arguments and outputs of K2's int form).
    Bytes: every row's leaf id read and written per class; a weighted row
    that lands in a histogram slot of some class reads its count weight
    once, and when the launch builds histograms also its G bins once and
    its grad and hess for each class whose slot it lands in (float32: 8 B,
    int8: 2 B); a routed row (its leaf splits) reads the bin of its split
    group unless it reads all G bins already; the histograms (4 B a cell)
    and counts are written once.
    A launch with categorical records also reads its (K, L, W) bitset words
    once.
    Operations: per row and class the leaf test (1); per routed row the bin
    address, compare, child and slot selects (4), +3 to unbundle an EFB
    bin, +1 per missing-value bin, +3 for a categorical record's bit test
    (word address, shift, mask); per weighted row in a slot two
    quantizations (2; none in the int form) and one add per group and
    channel (2G)."""
    import torch
    from lightgbm_torch.kernels import layout as tl

    bins_T, leaf_id, tabs, words, _, _, cnt, num_slots, max_bins = args[:9]
    with_hist = args[9] if int_form else args[10]
    w_bytes, quant_ops = (2, 0) if int_form else (8, 2)
    new_leaf, _, counts = out
    G, n = bins_T.shape
    # the row counts below, on the card, read in one transfer
    weighted = cnt > 0
    any_slot = torch.zeros(n, dtype=torch.bool, device=cnt.device)
    per_class, sums = [], []
    for k in range(leaf_id.shape[0]):
        lid = leaf_id[k]
        rec = tabs[k][lid.long()]
        chosen = rec[:, tl.R_CHOSEN] > 0
        went_left = new_leaf[k] == lid
        slot = torch.where(chosen, torch.where(
            went_left, rec[:, tl.R_SLOT_L], rec[:, tl.R_SLOT_R]),
            rec[:, tl.R_SLOT_KEEP])
        in_slot_rows = (slot >= 0) & weighted
        any_slot |= in_slot_rows
        sums.append(torch.stack([
            in_slot_rows.sum(), counts[k].sum().to(torch.int64),
            chosen.sum(), (chosen & (rec[:, tl.R_BUNDLED] > 0)).sum(),
            (chosen & (rec[:, tl.R_NANBIN] >= 0)).sum(),
            (chosen & (rec[:, tl.R_MZBIN] >= 0)).sum(),
            (chosen & (rec[:, tl.R_ISCAT] > 0)).sum(),
            (rec[:, tl.R_ISCAT] > 0).sum()]))
        per_class.append(chosen)
    reads = [(c & ~any_slot if with_hist else c).sum() for c in per_class]
    sums = torch.stack(sums).cpu().numpy().astype(np.float64)
    reads = torch.stack(reads).cpu().numpy().astype(np.float64)
    n_any = float(any_slot.sum().item())
    if (sums[:, 0] != sums[:, 1]).any():
        raise RuntimeError("k2_work: rows in slots disagree with the "
                           "counts")
    ops, n_bytes = 0.0, 4.0 * n_any
    if (sums[:, 7] > 0).any():
        n_bytes += 4.0 * words.numel()
    for (in_slot, _, n_chosen, n_bund, n_nan, n_mz, n_cat, _), bin_read in \
            zip(sums, reads):
        ops += (n + 4 * n_chosen + 3 * n_bund + n_nan + n_mz + 3 * n_cat)
        n_bytes += (8.0 * n + bin_read * bins_T.element_size()
                    + 4 * num_slots)
        if with_hist:
            ops += in_slot * (quant_ops + 2 * G)
            n_bytes += in_slot * w_bytes + num_slots * G * max_bins * 2 * 4
    if with_hist:
        n_bytes += n_any * G * bins_T.element_size()
    return n_bytes, ops


def time_k2_launches(items, int_form):
    """Device time of each captured K2 launch (``device_ms``), its plain
    version's (CUDA events, one call), its bound, and for launches with
    histograms one ``index_add_`` call over the same (row, class, group)
    triples (int32 for the int form): means over the launches."""
    from lightgbm_torch.kernels import route_hist as rh
    kernel, plain = ((rh.route_and_hist_int_cuda, rh.route_and_hist_int_plain)
                     if int_form else
                     (rh.route_and_hist_cuda, rh.route_and_hist_plain))
    ms, plain_ms, lib_ms, bnd = [], [], [], []
    for args, out in items:
        ms.append(device_ms(lambda a=args: kernel(*a)))
        plain_ms.append(cuda_ms(lambda a=args: plain(*a), reps=1, warmup=0))
        bnd.append(bound(*k2_work(args, out, int_form)))
        if out[1] is not None:
            acc, cell, vals = k2k_index_add_inputs(args)
            lib_ms.append(device_ms(lambda: acc.index_add_(0, cell, vals)))
            del acc, cell, vals
    mean = statistics.mean
    return {"launches_timed": len(items), "ms": ms, "mean_ms": mean(ms),
            "plain_ms": plain_ms, "mean_plain_ms": mean(plain_ms),
            "bound_ms": [b for b, _ in bnd],
            "mean_bound_ms": mean(b for b, _ in bnd), "bound_by": bnd[0][1],
            "index_add_ms": lib_ms,
            "mean_index_add_ms": mean(lib_ms) if lib_ms else None}


def bound(n_bytes, n_ops):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CORE_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def auc(y, p):
    """Area under the ROC curve (rank statistic, ties averaged)."""
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    _, inv, cnt = np.unique(p, return_inverse=True, return_counts=True)
    sums = np.bincount(inv, weights=ranks)
    ranks = (sums / cnt)[inv]
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    return float((ranks[y > 0].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def phase_train(ds, Xs, ys, iters, smi, timed_tree=2):
    """The full phase's 1M-row Dataset trained for ``iters`` iterations
    through ``lightgbm_torch.train`` at the north-star shape (binary, 255
    leaves, max_bin 63, split budget 64); the model then predicts the
    held-out rows through K1.  Its last arms: checkpoints and resume
    (``checkpoint_arm``), DART and RF (``boosting_arm``) and the refit of
    this model on fresh rows (``refit_arm``).  Returns the K2 and K4
    entries of the kernels line, and K3's ``refit`` entry."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.kernels import leaf_gather as lg

    from lightgbm_torch.utils.timer import host_reads

    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "verbosity": -1}
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    tree_s, cap = timed.seconds, timed.cap
    launches = kernels.launch_counts()
    n_trees = bst.num_trees()
    if n_trees != iters or launches["route_and_hist"] == 0 \
            or launches["leaf_gather"] != iters:
        raise RuntimeError(f"training made {n_trees} trees with launches "
                           f"{launches}")
    leaves = [t.num_leaves for t in bst.engine.models]

    # held-out AUC through Booster.predict (K1)
    t0 = time.perf_counter()
    pred = bst.predict(Xs)
    predict_s = time.perf_counter() - t0
    held_auc = auc(ys, pred)
    if not (np.isfinite(pred).all() and held_auc > 0.80):
        raise RuntimeError(f"held-out AUC {held_auc}")

    # determinism: the first 3 trees again, byte for byte
    again = lt.train(params, ds, 3)
    if model_trees_text(again) != model_trees_text(bst, num_iteration=3):
        raise RuntimeError("training does not repeat bit for bit")

    # K2 and K4 of one tree: each launch against its plain version, then
    # timed launch by launch
    replayed, err = replay_against_plain(cap)
    full = time_k2_launches([(a, o) for a, o in cap.k2 if a[10]], False)
    route = time_k2_launches([(a, o) for a, o in cap.k2 if not a[10]], False)
    (lid, vals), _ = cap.k4[0]
    k4_ms = device_ms(lambda: lg.leaf_gather_cuda(lid, vals))
    k4_plain = device_ms(lambda: lg.leaf_gather_plain(lid, vals))
    k4_lib = device_ms(lambda: torch.index_select(vals, 0, lid))
    k4_bnd = bound(8.0 * lid.numel() + 4.0 * vals.numel(), lid.numel())

    # the fused iteration (the main path) against the eager one
    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    # one more iteration, its phases timed (synchronised at every boundary)
    profiled_s, phases_s, prof_reads = profiled_iteration(bst)
    constrained = constrained_arm(params, ds, Xs, ys, iters, held_auc,
                                  timed_tree)
    methods = {}
    for name, (extra, gate, sweep) in higgs_method_arms(
            ds.num_feature()).items():
        t0 = time.perf_counter()
        # an eager tree of the monotone methods takes seconds: one, and the
        # phase-timed one after it, no traced one; their fused trees take
        # 0.27-0.74 s: half the iterations
        methods[name] = method_arm(extra, gate, sweep, params, ds, Xs, ys,
                                   min(iters, 10) if sweep else iters,
                                   timed_tree,
                                   eager_iters=1 if sweep else 2,
                                   trace_eager=not sweep)
        methods[name]["wall_s"] = time.perf_counter() - t0
    extras = {}
    for name, arm in (("cegb", cegb_arm), ("forced", forced_arm),
                      ("linear", linear_arm)):
        t0 = time.perf_counter()
        extras[name] = arm(params, ds, Xs, ys, iters, timed_tree,
                           bst.engine.models[:iters], held_auc)
        extras[name]["wall_s"] = time.perf_counter() - t0
    # checkpoints and resume, DART, RF, and the refit of this model
    boosting, boost_err = {}, {}
    t0 = time.perf_counter()
    boosting["checkpoint"] = checkpoint_arm(params, ds)
    boosting["checkpoint"]["wall_s"] = time.perf_counter() - t0
    for kind, gate in (("dart", 0.80), ("rf", 0.75)):
        t0 = time.perf_counter()
        boosting[kind], boost_err[kind] = boosting_arm(
            kind, params, ds, Xs, ys, iters, timed_tree, gate)
        boosting[kind]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    boosting["refit"], k3_refit = refit_arm(bst, ds, iters)
    boosting["refit"]["wall_s"] = time.perf_counter() - t0

    after_first = tree_s[1:] or tree_s
    emit({"phase": "train", "card": smi, "rows": int(ds.num_data()),
          "features": int(ds.num_feature()), "iterations": iters,
          "num_leaves": 255, "leaves_per_tree": leaves,
          "train_s": train_s, "s_per_tree": statistics.median(after_first),
          "first_tree_s": tree_s[0], "tree_s": tree_s,
          "k2_launches_per_tree": launches["route_and_hist"] / iters,
          "replayed_launches_timed_tree": replayed,
          "replay_max_abs_err": err, "k2_full_hist": full,
          "k2_route_only": route,
          "k4_ms": k4_ms, "k4_plain_ms": k4_plain, "k4_library_ms": k4_lib,
          "predict_s": predict_s, "held_out_auc": held_auc,
          "determinism_first_3_trees_identical": True,
          "profiled_iteration_s": profiled_s,
          "profiled_iteration_phases_s": phases_s,
          "profiled_iteration_host_reads": prof_reads,
          "fused_iter": fused, "constrained": constrained,
          "methods": methods, "extras": extras, **boosting})
    for e in boost_err.values():
        for name in err:
            err[name] = max(err[name], e[name])
    k2 = {"name": "route_and_hist", "route": "cuda",
          "source": KERNEL_SOURCES["route_and_hist"],
          "replaces": KERNEL_REPLACES["route_and_hist"],
          "launches": launches["route_and_hist"],
          "max_abs_err": err["route_and_hist"],
          "ms": full["mean_ms"], "plain_ms": full["mean_plain_ms"],
          "bound_ms": full["mean_bound_ms"], "bound_by": full["bound_by"],
          "library_ms": full["mean_index_add_ms"]}
    k4 = {"name": "leaf_gather", "route": "cuda",
          "source": KERNEL_SOURCES["leaf_gather"],
          "replaces": KERNEL_REPLACES["leaf_gather"],
          "launches": launches["leaf_gather"],
          "max_abs_err": err["leaf_gather"],
          "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bnd[0],
          "bound_by": k4_bnd[1], "library_ms": k4_lib}
    return [k2, k4], k3_refit


# monotone signs of higgs_logit's additive terms (x0, -x1, x7), and
# interaction groups that keep its x2 * x3 term together and list every
# feature
HIGGS_MONOTONE = {0: 1, 1: -1, 7: 1}
HIGGS_GROUPS = [[2, 3], [0, 1] + list(range(4, 28))]


def leaf_paths(tree):
    """Each leaf's root-to-leaf split features of a host tree."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        feats = feats | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), feats)
        walk(int(tree.right_child[node]), feats)

    if tree.num_leaves > 1:
        walk(0, frozenset())
    return out


def monotone_sweeps(bst, Xs, sweep_rows, points):
    """K1's raw predictions along a ``points``-point sweep of each feature
    of ``HIGGS_MONOTONE`` on ``sweep_rows`` held-out rows, one launch a
    sweep; raises unless each steps only with its feature's sign."""
    from lightgbm_torch import kernels

    grid = np.linspace(-3.0, 3.0, points, dtype=np.float32)
    sweeps = {}
    for f, sign in HIGGS_MONOTONE.items():
        Xw = np.repeat(Xs[:sweep_rows], points, axis=0)
        Xw[:, f] = np.tile(grid, sweep_rows)
        kernels.reset_launch_counts()
        raw = bst.predict(Xw, raw_score=True).reshape(sweep_rows, points)
        k1 = kernels.launch_counts()["predict_stream"]
        steps = np.diff(raw.astype(np.float64), axis=1) * sign
        if k1 != 1 or steps.min() < 0:
            raise RuntimeError(f"feature {f}: K1 launches {k1}, a step "
                               f"against its sign {steps.min()}")
        sweeps[f] = {"sign": sign, "rows_moved": int((steps.max(axis=1)
                                                      > 0).sum()),
                     "largest_step": float(steps.max())}
    return sweeps


def constrained_arm(params, ds, Xs, ys, iters, plain_auc, timed_tree,
                    sweep_rows=1_000, points=64):
    """phase train's constrained arm on its 1M-row Dataset: monotone
    constraints (``HIGGS_MONOTONE``), interaction constraints
    (``HIGGS_GROUPS``) and ``path_smooth`` 1.0, ``iters`` fused trees
    (constrained single trees fuse; no route fusion applies unsampled).
    Held-out AUC > 0.75 beside the unconstrained run's; K1's predictions
    monotone along a ``points``-point sweep of each constrained feature on
    ``sweep_rows`` held-out rows; every leaf's path features inside one
    group; one tree's launches replayed bit-equal."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels

    F = ds.num_feature()
    mono = [HIGGS_MONOTONE.get(f, 0) for f in range(F)]
    p = {**params, "monotone_constraints": mono,
         "interaction_constraints": HIGGS_GROUPS, "path_smooth": 1.0}
    kernels.reset_launch_counts()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(p, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if bst.num_trees() != iters or launches["route_and_hist"] == 0:
        raise RuntimeError(f"constrained training: {bst.num_trees()} trees "
                           f"with launches {launches}")
    pred = bst.predict(Xs)
    c_auc = auc(ys, pred)
    if not (np.isfinite(pred).all() and c_auc > 0.75):
        raise RuntimeError(f"constrained held-out AUC {c_auc}")
    groups = [set(g) for g in HIGGS_GROUPS]
    for tree in bst.engine.models:
        for path in leaf_paths(tree):
            if not any(path <= g for g in groups):
                raise RuntimeError(f"a leaf's path {sorted(path)} crosses "
                                   f"the interaction groups")
    sweeps = monotone_sweeps(bst, Xs, sweep_rows, points)
    replayed, err = replay_against_plain(timed.cap)
    if not (replayed["route_and_hist"] and replayed["leaf_gather"]):
        raise RuntimeError(f"constrained training replayed {replayed}")
    return {"iterations": iters, "fused": bool(bst.engine._fused),
            "train_s": train_s, "tree_s": timed.seconds,
            "s_per_tree": statistics.median(timed.seconds[1:]),
            "launches": launches, "held_out_auc": c_auc,
            "unconstrained_held_out_auc": plain_auc,
            "leaves_per_tree": [t.num_leaves for t in bst.engine.models],
            "paths_inside_one_group": True, "monotone_sweeps": sweeps,
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err}


def higgs_method_arms(F):
    """phase train's arms of the monotone methods and the per-node draws:
    (a) ``HIGGS_MONOTONE`` under the intermediate method, (b) under the
    advanced one, (c) by-node sampling at 0.5 with extra trees; each with
    its held-out AUC gate and whether K1's sweeps must be monotone."""
    mono = [HIGGS_MONOTONE.get(f, 0) for f in range(F)]
    return {
        "intermediate": ({"monotone_constraints": mono,
                          "monotone_constraints_method": "intermediate"},
                         0.75, True),
        "advanced": ({"monotone_constraints": mono,
                      "monotone_constraints_method": "advanced"}, 0.75, True),
        "bynode_extra_trees": ({"feature_fraction_bynode": 0.5,
                                "extra_trees": True}, 0.80, False)}


def method_arm(extra, gate, sweep, params, ds, Xs, ys, iters, timed_tree,
               eager_iters=2, sweep_rows=1_000, points=64, trace_eager=True):
    """One of ``higgs_method_arms`` on phase train's 1M-row Dataset:
    ``iters`` fused trees (the counts read around them), the held-out AUC
    above ``gate``, K1's sweeps monotone (``sweep``), one tree's K2 and K4
    launches replayed bit-equal, the fused numbers (``arm_numbers``: s per
    tree, the idle share of one more iteration); then ``eager_iters`` trees
    with ``fused_iter`` off, their text equal to the fused trees', their
    numbers (the idle share's traced iteration only with ``trace_eager``),
    and one more eager tree timed by phase (``mono_pairs``: the serial
    per-pair update, ``mono_slabs``: the slab refresh)."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.utils.timer import host_reads

    p = {**params, **extra}
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(p, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    eng = bst.engine
    if (bst.num_trees() != iters or launches["route_and_hist"] == 0
            or launches["leaf_gather"] != iters or not eng._fused
            or eng._graphs.replays == 0):
        raise RuntimeError(f"{extra}: {bst.num_trees()} trees, fused "
                           f"{eng._fused}, launches {launches}")
    pred = bst.predict(Xs)
    held_auc = auc(ys, pred)
    if not (np.isfinite(pred).all() and held_auc > gate):
        raise RuntimeError(f"{extra}: held-out AUC {held_auc}")
    sweeps = monotone_sweeps(bst, Xs, sweep_rows, points) if sweep else None
    replayed, err = replay_against_plain(timed.cap)
    if not (replayed["route_and_hist"] and replayed["leaf_gather"]):
        raise RuntimeError(f"{extra}: replayed {replayed}")
    leaves = [t.num_leaves for t in eng.models]
    fused = arm_numbers(bst, timed, launches, reads)
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters() as e_timed:
        eager = lt.train({**p, "fused_iter": "off"}, ds, eager_iters)
    e_reads = host_reads() - r0
    e_launches = kernels.launch_counts()
    if eager.engine._fused or model_trees_text(eager) != model_trees_text(
            bst, num_iteration=eager_iters):
        raise RuntimeError(f"{extra}: fused and eager trees differ")
    eager_numbers = arm_numbers(eager, e_timed, e_launches, e_reads,
                                trace=trace_eager)
    prof_s, phases_s, prof_reads = profiled_iteration(eager)
    return {"iterations": iters, "train_s": train_s,
            "tree_s": timed.seconds,
            "k2_launches_per_tree": launches["route_and_hist"] / iters,
            "launches": launches, "held_out_auc": held_auc,
            "leaves_per_tree": leaves, "monotone_sweeps": sweeps,
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err, "fused": fused,
            "eager": eager_numbers, "eager_iterations": eager_iters,
            "fused_eager_text_identical": True,
            "profiled_eager_iteration_s": prof_s,
            "profiled_eager_iteration_phases_s": phases_s,
            "profiled_eager_iteration_host_reads": prof_reads,
            "mono_pairs_s_per_tree": phases_s.get("mono_pairs"),
            "mono_slabs_s_per_tree": phases_s.get("mono_slabs")}


# phase train's CEGB arm: a split cost of 5e-3 a row of the leaf, a coupled
# cost of 2000 on two of higgs_logit's signal features (its x2 * x3 term)
# and a lazy cost of 0.02 a row on two others (-0.6 |x6|, 0.5 x7); sized
# on 100 000 rows on the CPU (the costs and the gains both scale with the
# rows, the coupled cost taken 10x) so that each moves the model
HIGGS_CEGB_SPLIT = 5e-3
HIGGS_CEGB_COUPLED = {2: 2000.0, 3: 2000.0}
HIGGS_CEGB_LAZY = {6: 0.02, 7: 0.02}
# phase train's forced tree: x0 at 0, its children x1 and x2 at 0
HIGGS_FORCED = {"feature": 0, "threshold": 0.0,
                "left": {"feature": 1, "threshold": 0.0},
                "right": {"feature": 2, "threshold": 0.0}}


def split_counts(trees, F):
    """(F,) the splits on each feature over host trees."""
    counts = np.zeros(F, np.int64)
    for t in trees:
        np.add.at(counts, np.asarray(t.split_feature[:t.num_leaves - 1],
                                     np.int64), 1)
    return counts


def timed_train(p, ds, iters, timed_tree):
    """``iters`` iterations of ``lightgbm_torch.train`` timed (TimedIters,
    one tree's launches captured), the kernel counts and host reads read
    around them: (booster, timed, launches, reads, seconds)."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.utils.timer import host_reads

    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(p, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    return (bst, timed, kernels.launch_counts(), host_reads() - r0,
            train_s)


def extra_arm_checks(name, bst, timed, launches, iters, Xs, ys, gate,
                     k4=True):
    """An extra arm's common gates: ``iters`` trees with K2 launched (and
    K4 once a tree unless ``k4`` is off: linear trees add a host delta),
    the held-out AUC above ``gate``, one tree's K2 (and K4) launches
    replayed bit-equal.  Returns (AUC, predict seconds, replayed, err)."""
    if (bst.num_trees() != iters or launches["route_and_hist"] == 0
            or (k4 and launches["leaf_gather"] != iters)):
        raise RuntimeError(f"{name}: {bst.num_trees()} trees with launches "
                           f"{launches}")
    t0 = time.perf_counter()
    pred = bst.predict(Xs)
    predict_s = time.perf_counter() - t0
    held_auc = auc(ys, pred)
    if not (np.isfinite(pred).all() and held_auc > gate):
        raise RuntimeError(f"{name}: held-out AUC {held_auc}")
    replayed, err = replay_against_plain(timed.cap)
    if not (replayed["route_and_hist"]
            and (replayed["leaf_gather"] or not k4)):
        raise RuntimeError(f"{name}: replayed {replayed}")
    return held_auc, predict_s, replayed, err


def cegb_arm(params, ds, Xs, ys, iters, timed_tree, plain_trees, plain_auc):
    """CEGB on phase train's 1M-row Dataset, eager (the reference gates it
    out of fusion): ``iters`` trees under ``HIGGS_CEGB_*``, every penalised
    feature split fewer times than in the plain arm's trees, the held-out
    AUC > 0.75, the lazy bitset's bytes, one tree's launches replayed, the
    arm's numbers (s per tree, the idle share of one more iteration) and
    one more iteration timed by phase (``split_scan`` holds the lazy
    counts)."""
    F = ds.num_feature()
    coupled, lazy = [0.0] * F, [0.0] * F
    for f, v in HIGGS_CEGB_COUPLED.items():
        coupled[f] = v
    for f, v in HIGGS_CEGB_LAZY.items():
        lazy[f] = v
    p = {**params, "cegb_penalty_split": HIGGS_CEGB_SPLIT,
         "cegb_penalty_feature_coupled": coupled,
         "cegb_penalty_feature_lazy": lazy}
    bst, timed, launches, reads, train_s = timed_train(p, ds, iters,
                                                       timed_tree)
    eng = bst.engine
    if eng._fused:
        raise RuntimeError("CEGB fused")
    held_auc, predict_s, replayed, err = extra_arm_checks(
        "cegb", bst, timed, launches, iters, Xs, ys, 0.75)
    got = split_counts(eng.models[:iters], F)
    plain = split_counts(plain_trees, F)
    penalised = sorted(HIGGS_CEGB_COUPLED) + sorted(HIGGS_CEGB_LAZY)
    if not all(got[f] < plain[f] for f in penalised):
        raise RuntimeError(f"CEGB: splits on {penalised} {got[penalised]} "
                           f"against the plain arm's {plain[penalised]}")
    lazy_t = eng._cegb.lazy
    numbers = arm_numbers(bst, timed, launches, reads)
    prof_s, phases_s, prof_reads = profiled_iteration(bst)
    return {"iterations": iters, "train_s": train_s,
            "tree_s": timed.seconds, "s_per_tree": numbers["s_per_tree"],
            "k2_launches_per_tree": launches["route_and_hist"] / iters,
            "launches": launches, "held_out_auc": held_auc,
            "plain_held_out_auc": plain_auc, "predict_s": predict_s,
            "penalised_features": penalised,
            "splits_on_penalised": got[penalised].tolist(),
            "plain_splits_on_penalised": plain[penalised].tolist(),
            "leaves_per_tree": [t.num_leaves for t in eng.models[:iters]],
            "lazy_bitset_bytes": lazy_t.numel() * lazy_t.element_size(),
            "rows_charged_per_feature": lazy_t.sum(dim=0).tolist(),
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err, "eager": numbers,
            "profiled_iteration_s": prof_s,
            "profiled_iteration_phases_s": phases_s,
            "profiled_iteration_host_reads": prof_reads}


def forced_arm(params, ds, Xs, ys, iters, timed_tree, plain_trees,
               plain_auc):
    """Forced splits on phase train's 1M-row Dataset (``HIGGS_FORCED``):
    ``iters`` fused trees (each forced level a captured round), every
    tree's top three nodes the forced ones, the held-out AUC > 0.80, one
    tree's launches replayed, the fused numbers; then ``EAGER_ITERS`` trees
    with ``fused_iter`` off, their text equal to the fused trees', their
    numbers."""
    import lightgbm_torch as lt

    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "forced.json"
        spec.write_text(json.dumps(HIGGS_FORCED))
        p = {**params, "forcedsplits_filename": str(spec)}
        bst, timed, launches, reads, train_s = timed_train(p, ds, iters,
                                                           timed_tree)
        eng = bst.engine
        if not eng._fused or eng._graphs.replays == 0:
            raise RuntimeError("forced splits did not fuse")
        held_auc, predict_s, replayed, err = extra_arm_checks(
            "forced", bst, timed, launches, iters, Xs, ys, 0.80)
        for t in eng.models[:iters]:
            lc, rc = int(t.left_child[0]), int(t.right_child[0])
            if not (int(t.split_feature[0]) == 0 and lc >= 0 and rc >= 0
                    and int(t.split_feature[lc]) == 1
                    and int(t.split_feature[rc]) == 2):
                raise RuntimeError("a tree's top nodes are not the forced "
                                   "ones")
        fused = fused_and_eager(bst, timed, launches, reads,
                                lambda extra, n: lt.train({**p, **extra},
                                                          ds, n), iters)
    return {"iterations": iters, "train_s": train_s,
            "tree_s": timed.seconds,
            "s_per_tree": fused["fused"]["s_per_tree"],
            "k2_launches_per_tree": launches["route_and_hist"] / iters,
            "launches": launches, "held_out_auc": held_auc,
            "plain_held_out_auc": plain_auc, "predict_s": predict_s,
            "top_nodes_forced": True,
            "leaves_per_tree": [t.num_leaves for t in eng.models[:iters]],
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err, "fused_iter": fused}


def linear_arm(params, ds, Xs, ys, iters, timed_tree, plain_trees,
               plain_auc, linear_iters=5, held_out=250_000):
    """Linear trees on phase train's 1M-row Dataset: ``linear_iters``
    eager trees (each leaf's ridge fit on the host), the fit's seconds (the
    device synchronised before each) and their share of a tree, every tree
    after the first with coefficients, ``held_out`` of the held-out rows
    through the host walk (AUC > 0.80; ~9 s on 1M rows), one tree's K2
    launches replayed, the arm's numbers."""
    import torch
    from lightgbm_torch.models.gbdt import GBDT

    fit = GBDT._fit_linear_tree
    fit_s = []

    def timed_fit(eng, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(eng, *a)
        fit_s.append(time.perf_counter() - t0)
        return out

    GBDT._fit_linear_tree = timed_fit
    try:
        p = {**params, "linear_tree": True}
        bst, timed, launches, reads, train_s = timed_train(
            p, ds, linear_iters, min(timed_tree, linear_iters - 1))
        trees = list(bst.engine.models)
        if not all(t.is_linear for t in trees) or not all(
                any(len(c) for c in t.leaf_coeff) for t in trees[1:]):
            raise RuntimeError("linear trees without coefficients")
        held_auc, predict_s, replayed, err = extra_arm_checks(
            "linear", bst, timed, launches, linear_iters, Xs[:held_out],
            ys[:held_out], 0.80, k4=False)
        fits = list(fit_s)
        numbers = arm_numbers(bst, timed, launches, reads)
    finally:
        GBDT._fit_linear_tree = fit
    shares = [f / t for f, t in zip(fits, timed.seconds)]
    return {"iterations": linear_iters, "train_s": train_s,
            "tree_s": timed.seconds, "s_per_tree": numbers["s_per_tree"],
            "fit_s": fits, "fit_share_of_tree": shares,
            "fit_share_median": statistics.median(shares[1:] or shares),
            "k2_launches_per_tree": launches["route_and_hist"]
            / linear_iters, "launches": launches,
            "held_out_auc": held_auc, "plain_held_out_auc": plain_auc,
            "host_predict_s": predict_s,
            "held_out_rows": min(held_out, len(ys)),
            "coefficients_per_tree": [sum(len(c) for c in t.leaf_coeff)
                                      for t in trees],
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err, "eager": numbers}


# --------------------------------------------------------------------------
# checkpoints, DART, RF and refit (phase train's last arms)
# --------------------------------------------------------------------------

class OuterIters:
    """Times each whole iteration of a boosting class (its own
    ``train_one_iter``: DART's drops, walks and rescales, RF's averaging,
    around the gbdt iteration ``TimedIters`` times), the device
    synchronised at its end.  For DART it also records each iteration's
    dropped trees and the seconds spent walking trees into the score
    (``DART._walk_trees``, synchronised)."""

    def __init__(self, cls):
        self.cls, self.seconds, self.drops, self.walk_s = cls, [], [], []

    def __enter__(self):
        import torch
        self._orig = orig = self.cls.train_one_iter
        self._walk = walk = getattr(self.cls, "_walk_trees", None)

        def timed(eng, *a, **kw):
            self.walk_s.append(0.0)
            t0 = time.perf_counter()
            out = orig(eng, *a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.drops.append(len(getattr(eng, "last_drop", ())))
            return out

        def timed_walk(eng, pairs, scale=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walk(eng, pairs, scale)
            torch.cuda.synchronize()
            self.walk_s[-1] += time.perf_counter() - t0

        self.cls.train_one_iter = timed
        if walk is not None:
            self.cls._walk_trees = timed_walk
        return self

    def __exit__(self, *exc):
        self.cls.train_one_iter = self._orig
        if self._walk is not None:
            self.cls._walk_trees = self._walk


class Timed:
    """Seconds of every call of ``owner.name`` while active (the device
    synchronised before and after each)."""

    def __init__(self, owner, name):
        self.owner, self.name, self.seconds = owner, name, []

    def __enter__(self):
        import torch
        self._orig = orig = getattr(self.owner, self.name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)


# the checkpoint arm's second run: its bagging keys and feature-fraction
# draws must carry across the resume
CHECKPOINT_ARMS = {"plain": {},
                   "bagged": {"bagging_fraction": 0.8, "bagging_freq": 1,
                              "feature_fraction": 0.8}}


def checkpoint_arm(params, ds, iters=10, freq=5):
    """Checkpoint and resume on phase train's 1M-row Dataset, fused under
    ``stream``: for each of ``CHECKPOINT_ARMS``, ``iters`` iterations with a
    snapshot every ``freq``, then a run resumed from the first snapshot
    whose model text must equal the uninterrupted run's byte for byte on
    the card; the seconds to write a checkpoint, and to resume from one
    (validate and load, the trees loaded without the score walk, the state
    restored)."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import basic
    from lightgbm_torch.models.gbdt import GBDT
    from lightgbm_torch.robustness import checkpoint as ck

    out = {}
    for name, extra in CHECKPOINT_ARMS.items():
        with tempfile.TemporaryDirectory() as tmp:
            p = {**params, **extra, "snapshot_freq": freq,
                 "output_model": str(Path(tmp) / "model.txt")}
            with Timed(basic.Booster, "checkpoint") as write:
                t0 = time.perf_counter()
                full = lt.train(p, ds, iters)
                torch.cuda.synchronize()
                full_s = time.perf_counter() - t0
            snap = ck.snapshot_path(p["output_model"], freq)
            with Timed(ck, "load_checkpoint") as load, \
                    Timed(GBDT, "load_init_model") as seed, \
                    Timed(ck, "restore_state") as restore:
                t0 = time.perf_counter()
                resumed = lt.train(p, ds, iters, resume_from=snap)
                torch.cuda.synchronize()
                resumed_s = time.perf_counter() - t0
            state_bytes = Path(snap + ck.STATE_SUFFIX).stat().st_size
            model_bytes = Path(snap).stat().st_size
        if not (full.engine._fused and resumed.engine._fused
                and full.num_trees() == iters):
            raise RuntimeError(f"checkpoint {name}: fused "
                               f"{full.engine._fused} / "
                               f"{resumed.engine._fused}, "
                               f"{full.num_trees()} trees")
        if resumed.model_to_string() != full.model_to_string():
            raise RuntimeError(f"checkpoint {name}: the resumed model "
                               "differs from the uninterrupted one")
        out[name] = {
            "iterations": iters, "snapshot_freq": freq,
            "resumed_from_iteration": freq, "text_identical": True,
            "train_s": full_s, "resumed_train_s": resumed_s,
            "checkpoint_write_s": write.seconds,
            "resume_s": load.seconds[0] + seed.seconds[0]
            + restore.seconds[0],
            "resume_breakdown_s": {"validate_and_load": load.seconds[0],
                                   "load_trees": seed.seconds[0],
                                   "restore_state": restore.seconds[0]},
            "state_bytes": state_bytes, "model_bytes": model_bytes}
    return out


def boosting_arm(kind, params, ds, Xs, ys, iters, timed_tree, gate,
                 held_out=250_000):
    """DART (``drop_rate`` 0.1, ``skip_drop`` 0.5) or RF (bagging 0.7
    every iteration) on phase train's 1M-row Dataset: ``iters`` trees with
    the kernel counts read around them (K2 launched, K4 once a tree), the
    held-out AUC on ``held_out`` rows above ``gate``, one tree's K2, K3 and
    K4 launches replayed bit-equal, s a tree (whole iterations: DART's
    drops and rescales, RF's averaging); DART's dropped trees an iteration
    and the share of the iteration spent walking them."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.models.gbdt import DART, RF
    from lightgbm_torch.utils.timer import host_reads

    cls, extra = {"dart": (DART, {"boosting": "dart", "drop_rate": 0.1,
                                  "skip_drop": 0.5}),
                  "rf": (RF, {"boosting": "rf", "bagging_fraction": 0.7,
                              "bagging_freq": 1})}[kind]
    p = {**params, **extra}
    kernels.reset_launch_counts()
    r0 = host_reads()
    with OuterIters(cls) as outer, \
            TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(p, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    eng = bst.engine
    if not isinstance(eng, cls) or eng._fused != (kind == "dart"):
        raise RuntimeError(f"{kind}: engine {type(eng).__name__}, fused "
                           f"{eng._fused}")
    held_auc, predict_s, replayed, err = extra_arm_checks(
        kind, bst, timed, launches, iters, Xs[:held_out], ys[:held_out],
        gate)
    after_first = outer.seconds[1:] or outer.seconds
    line = {"iterations": iters, "train_s": train_s,
            "tree_s": outer.seconds,
            "s_per_tree": statistics.median(after_first),
            "k2_launches": launches["route_and_hist"],
            "k4_launches": launches["leaf_gather"],
            "k3_launches": launches["route_replay"],
            "k2_launches_per_tree": launches["route_and_hist"] / iters,
            "launches": launches, "host_reads_per_tree": reads / iters,
            "held_out_auc": held_auc, "held_out_rows": min(held_out,
                                                           len(ys)),
            "predict_s": predict_s,
            "leaves_per_tree": [t.num_leaves for t in eng.models],
            "replayed_launches_timed_tree": replayed,
            "replay_max_abs_err": err}
    if kind == "dart":
        shares = [w / t for w, t in zip(outer.walk_s, outer.seconds)]
        line.update({"dropped_trees_per_iteration": outer.drops,
                     "dropped_trees_mean": statistics.mean(outer.drops),
                     "walk_s": outer.walk_s, "walk_share": shares,
                     "walk_share_median": statistics.median(
                         shares[1:] or shares),
                     "shrinkage_per_tree": [t.shrinkage
                                            for t in eng.models]})
    return line, err


def refit_arm(bst, ds, iters, seed=7, rows=1_000_000):
    """``refit_leaf_values`` of phase train's model (its first ``iters``
    iterations) on ``rows`` fresh rows
    (binned on the card with ``reference=`` the training Dataset): one K3
    launch a numeric tree, counted around the refit; every launch held
    against ``route_replay_plain`` bit for bit; the refitted model text
    equal to the refit run with the plain version; K3 timed on the deepest
    tree's launch beside its plain version and bound; the refit's seconds
    and the share of them outside the leaf assignment (the host's
    gradients and float64 sums).  Returns the line and K3's ``refit``
    entry for the kernels line."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels, refit
    from lightgbm_torch.kernels import route_replay as rr

    Xf, yf = make_higgs_like(rows, 28, seed + 101)
    t0 = time.perf_counter()
    fresh = lt.Dataset(Xf, label=yf, reference=ds).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    text = bst.model_to_string(num_iteration=iters)
    calls = []
    route = refit.route_replay

    def recorded(bins_T, tabs):
        out = route(bins_T, tabs)
        calls.append((bins_T, tabs.clone(), out.clone()))
        return out

    card = lt.Booster(model_str=text)
    kernels.reset_launch_counts()
    refit.route_replay = recorded
    try:
        with Timed(refit, "device_leaf_ids") as ids:
            t0 = time.perf_counter()
            report = refit.refit_leaf_values(card, fresh, decay_rate=0.9)
            refit_s = time.perf_counter() - t0
    finally:
        refit.route_replay = route
    launches = kernels.launch_counts()
    n_trees = len(card._all_trees())
    if not (launches["route_replay"] == report["route_replay_passes"]
            == len(calls) == n_trees):
        raise RuntimeError(f"refit: {report} with launches {launches}")
    err = 0.0
    for bins_T, tabs, out in calls:
        want = rr.route_replay_plain(bins_T, tabs)
        diff = max_abs_diff(out, want)
        err = max(err, diff)
        if not torch.equal(out, want):
            raise RuntimeError(f"refit: route_replay differs from its plain "
                               f"version (max abs {diff})")
    plain = lt.Booster(model_str=text)
    refit.route_replay = rr.route_replay_plain
    try:
        refit.refit_leaf_values(plain, fresh, decay_rate=0.9)
    finally:
        refit.route_replay = route
    refitted = card.model_to_string()
    if plain.model_to_string() != refitted or refitted == text:
        raise RuntimeError("refit: the card's refitted model differs from "
                           "the plain version's, or nothing changed")
    bins_T, tabs, _ = max(calls, key=lambda c: c[1].shape[0])
    k3_ms = device_ms(lambda: rr.route_replay_cuda(bins_T, tabs))
    k3_plain = cuda_ms(lambda: rr.route_replay_plain(bins_T, tabs), reps=1,
                       warmup=0)
    k3_bnd = bound(*k3_work(bins_T, tabs))
    leaf_s = ids.seconds[0]
    line = {"rows": rows, "trees": n_trees, "construct_s": construct_s,
            "refit_s": refit_s, "leaf_assignment_s": leaf_s,
            "host_sums_share": (refit_s - leaf_s) / refit_s,
            "report": report, "k3_launches": launches["route_replay"],
            "k3_rounds_timed": int(tabs.shape[0]),
            "k3_leaves_padded": int(tabs.shape[1]),
            "k3_ms": k3_ms, "k3_plain_ms": k3_plain,
            "k3_bound_ms": k3_bnd[0], "plain_text_identical": True}
    entry = {"launches": launches["route_replay"], "max_abs_err": err,
             "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bnd[0],
             "bound_by": k3_bnd[1], "library_ms": None,
             "rows": rows, "rounds": int(tabs.shape[0])}
    return line, entry


# --------------------------------------------------------------------------
# sampled training
# --------------------------------------------------------------------------

def sampled_params(kind):
    """Bagging at half the rows every iteration, or GOSS at rates whose
    amplification (1 - 0.5) / 0.25 = 2 keeps dyadic gradients dyadic
    (learning rate 0.5: two warmup iterations)."""
    if kind == "bagging":
        return {"bagging_fraction": 0.5, "bagging_freq": 1}
    return {"data_sample_strategy": "goss", "top_rate": 0.5,
            "other_rate": 0.25, "learning_rate": 0.5}


def phase_train_sampled_small(seed, n=20_000, iters=5, num_leaves=127):
    """Sampled training on both devices, dyadic custom gradients: bagging
    and GOSS must give byte-identical model text on the CPU and the card,
    with route fusion on and off, and GOSS also with row compaction pad and
    off; every K2, K3 and K4 launch of the card's fused runs is replayed
    bit-equal through its plain version, and each K3 launch against the
    chain of route-only K2 launches it fuses.  The same under scatter
    (compaction auto, pad and off) and pallas (uncompacted), CPU and card,
    one text; their card launches of K5 and K6 replayed."""
    import torch
    import lightgbm_torch as lt

    X, y = make_train_small(n, seed)
    base = {"objective": "none", "num_leaves": num_leaves,
            "max_splits_per_round": 64, "max_bin": 63, "verbosity": -1}
    cap = Capture()
    out = {}
    for kind in ("bagging", "goss"):
        runs = [("cpu", {}), ("cuda", {}), ("cuda", {"route_fusion": "off"})]
        if kind == "goss":
            runs += [("cuda", {"row_compaction": "pad"}),
                     ("cuda", {"row_compaction": "off"})]
        texts, compact = [], []
        for dev, extra in runs:
            p = {**base, **sampled_params(kind), **extra, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
            fused_card = dev == "cuda" and not extra
            with (cap if fused_card else contextlib.nullcontext()):
                for _ in range(iters):
                    bst.update(fobj=dyadic_fobj)
            texts.append(model_trees_text(bst))
            compact.append(bst.engine.last_compact_rows)
        if any(t != texts[0] for t in texts):
            raise RuntimeError(f"{kind}: sampled training differs between "
                               f"runs {[t == texts[0] for t in texts]}")
        if not compact[1] > 0:
            raise RuntimeError(f"{kind}: compaction did not engage")
        out[kind] = {"runs": [f"{d} {e}" for d, e in runs],
                     "text_identical": True, "compact_rows": compact,
                     "leaves_per_tree": [t.num_leaves
                                         for t in bst.engine.models]}
        # scatter (compacted, pad and off) and pallas (never compacted) on
        # both devices: one text; the card's default runs replayed
        nb_runs = [("cpu", "scatter", {}), ("cuda", "scatter", {}),
                   ("cuda", "scatter", {"row_compaction": "pad"}),
                   ("cuda", "scatter", {"row_compaction": "off"}),
                   ("cpu", "pallas", {}), ("cuda", "pallas", {})]
        nb_texts, nb_compact = [], []
        for dev, hb, extra in nb_runs:
            p = {**base, **sampled_params(kind), **extra, "hist_backend": hb,
                 "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
            with (cap if dev == "cuda" and not extra
                  else contextlib.nullcontext()):
                for _ in range(iters):
                    bst.update(fobj=dyadic_fobj)
            nb_texts.append(model_trees_text(bst))
            nb_compact.append(bst.engine.last_compact_rows)
        if any(t != nb_texts[0] for t in nb_texts):
            raise RuntimeError(f"{kind}: scatter/pallas sampled training "
                               f"differs {[t == nb_texts[0] for t in nb_texts]}")
        if not (nb_compact[1] > 0 and nb_compact[5] == 0):
            raise RuntimeError(f"{kind}: compaction {nb_compact}")
        out[kind].update({"backend_runs": [f"{d} {hb} {e}"
                                           for d, hb, e in nb_runs],
                          "backends_text_identical": True,
                          "backends_compact_rows": nb_compact})
    torch.cuda.synchronize()
    if not cap.k3:
        raise RuntimeError("the fused sampled runs launched no K3")
    replayed, err = replay_against_plain(cap)
    if not (replayed["scatter_hist"] and replayed["hist_direct"]):
        raise RuntimeError(f"the backends' sampled runs replayed {replayed}")
    fused_cpu = {kind: fused_against_cpu(
        X, y, {**base, **sampled_params(kind)}, iters)
        for kind in ("bagging", "goss")}
    emit({"phase": "train_sampled_small", "rows": n, "iterations": iters,
          "num_leaves": num_leaves, **out, "replayed_launches": replayed,
          "replay_max_abs_err": err,
          "fused_card_text_equals_eager_cpu": fused_cpu})
    return err


def k3_work(bins_T, tabs):
    """Bytes and operations one K3 launch needs on these inputs, counted
    from what the rows need: 4 B of leaf id written per row, one bin (a
    byte, two for 16-bit bins) per distinct group on a row's path, the
    records read once;
    operations per row and round the record select (1), per routed row the
    bin address, compare, child select and leaf update (4), +3 to unbundle
    an EFB bin, +1 per missing-value bin (the numeric part of k2_work's
    count)."""
    import torch
    from lightgbm_torch.kernels import layout as tl
    from lightgbm_torch.kernels.route_hist import numeric_go_left

    G, n = bins_T.shape
    rows = torch.arange(n, device=bins_T.device)
    lid = torch.zeros(n, dtype=torch.int64, device=bins_T.device)
    seen = torch.zeros((n, G), dtype=torch.bool, device=bins_T.device)
    ops = 0.0
    for r in range(tabs.shape[0]):
        rec = tabs[r][lid]
        chosen = rec[:, tl.R_CHOSEN] > 0
        grp = rec[:, tl.R_GROUP].to(torch.int64)
        seen[rows[chosen], grp[chosen]] = True
        ops += float(n + 4 * chosen.sum()
                     + 3 * (chosen & (rec[:, tl.R_BUNDLED] > 0)).sum()
                     + (chosen & (rec[:, tl.R_NANBIN] >= 0)).sum()
                     + (chosen & (rec[:, tl.R_MZBIN] >= 0)).sum())
        go_left, _ = numeric_go_left(bins_T, rows, rec)
        lid = torch.where(chosen & ~go_left, rec[:, tl.R_NEWID].long(), lid)
    n_bytes = (4.0 * n + float(seen.sum()) * bins_T.element_size()
               + 4.0 * tabs.numel())
    return n_bytes, ops


def phase_train_sampled(ds, Xs, ys, smi, iters=40, valid_rows=250_000,
                        timed_tree=12, patience=10, warmup=10):
    """GOSS at LightGBM's default rates (0.2 / 0.1) with feature_fraction
    0.8 on the full phase's 1M rows, 255 leaves, learning rate 0.1 (10
    warmup iterations, then sampled trees), with held-out rows as a
    validation set (AUC, early stopping): the main path of K3.  The same
    run unfused must grow byte-identical trees, and so must its first
    sampled trees in A/B arms run in turns (fused, unfused, without row
    compaction; each with the validation set); three sampled trees are
    trained again and must repeat byte for byte; every K2, K3 and K4 launch
    of one sampled tree is replayed bit-equal and then timed; one more
    iteration, and one without compaction, are timed phase by phase.  Returns the K3 entry of
    the kernels line and the replays' largest differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.kernels import leaf_gather as lg
    from lightgbm_torch.kernels import route_hist as rh, route_replay as rr

    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "data_sample_strategy": "goss",
              "top_rate": 0.2, "other_rate": 0.1, "feature_fraction": 0.8,
              "metric": "auc", "verbosity": -1}
    t0 = time.perf_counter()
    valid = lt.Dataset(Xs[:valid_rows], label=ys[:valid_rows],
                       reference=ds).construct()
    valid_s = time.perf_counter() - t0

    def run(extra, n_iter, **kw):
        return lt.train({**params, **extra}, ds, n_iter, **kw)

    from lightgbm_torch.utils.timer import host_reads

    record = {}
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as main:
        t0 = time.perf_counter()
        bst = run({}, iters, valid_sets=[valid],
                  callbacks=[lt.early_stopping(patience, verbose=False),
                             lt.record_evaluation(record)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    eng = bst.engine
    n_trees = bst.num_trees()
    n_sampled = n_trees - warmup
    if (n_sampled < 20 or launches["route_replay"] != n_sampled
            or launches["leaf_gather"] != n_trees
            or launches["route_and_hist"] == 0):
        raise RuntimeError(f"sampled training made {n_trees} trees with "
                           f"launches {launches}")
    aucs = record["valid_0"]["auc"]
    best = bst.best_score["valid_0"]["auc"]
    if not (np.isfinite(aucs).all() and best > 0.80
            and bst.best_iteration >= 1):
        raise RuntimeError(f"valid AUC {best} at {bst.best_iteration}")
    text = model_trees_text(bst, num_iteration=n_trees)
    sampled_rows, compact_rows = eng.last_sampled_rows, eng.last_compact_rows

    # the same run unfused: one route-only K2 pass over all rows per round
    kernels.reset_launch_counts()
    unfused = run({"route_fusion": "off"}, n_trees)
    launches_unfused = kernels.launch_counts()
    if model_trees_text(unfused) != text:
        raise RuntimeError("route fusion on and off grow different trees")
    # A/B arms in turns, each the warmup and 8 sampled trees with the
    # validation set: fused (the main path), unfused, and without row
    # compaction (histogram passes over all 1M rows with the mask)
    arms = {"fused": {}, "unfused": {"route_fusion": "off"},
            "no_compaction": {"row_compaction": "off"}}
    arm_s = {name: [] for name in arms}
    arm_bst = {}
    for name in ("fused", "unfused", "no_compaction", "no_compaction",
                 "unfused", "fused") * 2:
        with TimedIters() as arm_iters:
            arm_bst[name] = run(arms[name], warmup + 8, valid_sets=[valid],
                                callbacks=[lt.record_evaluation({})])
        if model_trees_text(arm_bst[name]) != model_trees_text(
                bst, num_iteration=warmup + 8):
            raise RuntimeError(f"the {name} arm grows different trees")
        arm_s[name].append(statistics.median(arm_iters.seconds[warmup:]))
    # determinism: the warmup and three sampled trees again
    again = run({}, warmup + 3)
    if model_trees_text(again) != model_trees_text(
            bst, num_iteration=warmup + 3):
        raise RuntimeError("sampled training does not repeat bit for bit")

    replayed, err = replay_against_plain(main.cap)
    if len(main.cap.k3) != 1:
        raise RuntimeError(f"the timed tree launched K3 "
                           f"{len(main.cap.k3)} times")
    (bins_T, tabs), _ = main.cap.k3[0]
    k3_ms = device_ms(lambda: rr.route_replay_cuda(bins_T, tabs))
    k3_plain = cuda_ms(lambda: rr.route_replay_plain(bins_T, tabs), reps=1,
                       warmup=0)
    k3_bytes, k3_ops = k3_work(bins_T, tabs)
    k3_bnd = bound(k3_bytes, k3_ops)
    k2_full = [(a, o) for a, o in main.cap.k2 if a[10]]
    k2_ms = [device_ms(lambda a=a: rh.route_and_hist_cuda(*a))
             for a, _ in k2_full]
    (lid, vals), _ = main.cap.k4[0]
    k4_ms = device_ms(lambda: lg.leaf_gather_cuda(lid, vals))
    # the fused iteration (the main path) against the eager one, with the
    # validation set
    fused = fused_and_eager(
        bst, main, launches, reads,
        lambda extra, n: run(extra, n, valid_sets=[valid],
                             callbacks=[lt.record_evaluation({})]), n_trees)
    prof = profiled_iteration(bst)
    prof_dense = profiled_iteration(arm_bst["no_compaction"])
    emit({"phase": "train_sampled", "card": smi, "rows": int(ds.num_data()),
          "valid_rows": valid.num_data(), "valid_binning_s": valid_s,
          "iterations": iters, "trees": n_trees, "warmup_trees": warmup,
          "num_leaves": 255,
          "leaves_per_tree": [t.num_leaves for t in eng.models[:n_trees]],
          "train_s": train_s,
          "s_per_tree_warmup": statistics.median(main.seconds[1:warmup]),
          "s_per_tree_sampled": statistics.median(main.seconds[warmup:]),
          "ab_s_per_tree_sampled": arm_s,
          "tree_s": main.seconds, "valid_auc": aucs,
          "best_iteration": bst.best_iteration, "best_valid_auc": best,
          "sampled_rows": sampled_rows, "compact_rows": compact_rows,
          "k2_launches_per_sampled_tree": len(main.cap.k2),
          "k3_launches": launches["route_replay"],
          "route_only_passes_per_sampled_tree": {
              "fused": launches["route_replay"] / n_sampled,
              "unfused": (launches_unfused["route_and_hist"]
                          - launches["route_and_hist"]) / n_sampled},
          "launches": launches, "launches_unfused": launches_unfused,
          "fusion_on_off_identical": True,
          "compaction_on_off_identical": True,
          "determinism_3_sampled_trees_identical": True,
          "replayed_launches_timed_tree": replayed,
          "replay_max_abs_err": err,
          "k3_ms": k3_ms, "k3_plain_ms": k3_plain, "k3_bytes": k3_bytes,
          "k3_ops": k3_ops, "k3_rounds": int(tabs.shape[0]),
          "k2_full_hist_compacted_ms": k2_ms,
          "k2_full_hist_compacted_mean_ms": statistics.mean(k2_ms),
          "k4_ms": k4_ms,
          "profiled_iteration_s": prof[0],
          "profiled_iteration_phases_s": prof[1],
          "profiled_iteration_host_reads": prof[2],
          "profiled_iteration_no_compaction_s": prof_dense[0],
          "profiled_iteration_no_compaction_phases_s": prof_dense[1],
          "fused_iter": fused})
    return {"name": "route_replay", "route": "cuda",
            "source": KERNEL_SOURCES["route_replay"],
            "replaces": KERNEL_REPLACES["route_replay"],
            "launches": launches["route_replay"],
            "max_abs_err": err["route_replay"],
            "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bnd[0],
            "bound_by": k3_bnd[1], "library_ms": None}, err


# --------------------------------------------------------------------------
# the non-stream backends
# --------------------------------------------------------------------------

def hist_work(name, args, out):
    """Bytes and operations one K5, K6, K7 or K8 launch needs on these
    inputs, counted from what the rows need.  Bytes: K5 reads every row's
    slot (4 B), K8 every row's slot of each class, K6/K7 every plan
    position's gather index (4 B) and each block's three scalars; a row
    that lands in a slot (of any class) reads its G bins and count weight
    once, and its grad and hess (8 B) for each class whose slot it lands
    in; the (K, S, G, Bmax, 3) float32 histograms are written once.
    Operations: per (row, class) in a slot the three weight conversions
    (3) and one add per group and channel (3G)."""
    if name in ("scatter_hist", "hist_wide"):
        bins_T, slot = args[0], args[1]
        G, n = bins_T.shape
        slots = slot if slot.dim() == 2 else slot[None]
        pairs = float((slots >= 0).sum().item())
        rows = float((slots >= 0).any(dim=0).sum().item())
        n_bytes = 4.0 * slots.numel()
    else:
        bins, gather_idx, scalars = args[0], args[1], args[2]
        G = bins.shape[1]
        pairs = rows = float((gather_idx < bins.shape[0]).sum().item())
        n_bytes = 4.0 * gather_idx.numel() + 4.0 * scalars.numel()
    n_bytes += (rows * (G * args[0].element_size() + 4) + pairs * 8
                + 4.0 * out.numel())
    return n_bytes, pairs * (3 + 3 * G)


def index_add_inputs(name, args):
    """The flattened (class, slot, group, bin) cell of every (row, class,
    group) triple of a K5, K6, K7 or K8 launch and the (grad, hess, count)
    it adds, for the library call ``index_add_`` (float32 sums, not exact),
    and its zeroed (K * S * G * Bmax, 3) output."""
    import torch
    from lightgbm_torch.kernels.layout import bin_values
    if name in ("scatter_hist", "hist_wide"):
        bins_T, slot, grad, hess, cnt, num_slots, max_bins = args[:7]
        if slot.dim() == 1:
            slot, grad, hess = slot[None], grad[None], hess[None]
        kk, rows = torch.nonzero(slot >= 0, as_tuple=True)
        s = kk * num_slots + slot[kk, rows].long()
        bins_rows = bins_T[:, rows].t()
        w = torch.stack([grad[kk, rows], hess[kk, rows], cnt[rows]], dim=1)
        n_cells = slot.shape[0] * num_slots
    else:
        (bins, gather_idx, scalars, grad, hess, cnt, num_slots,
         max_bins) = args[:8]
        slot = scalars[:, 0].repeat_interleave(args[9]).long()
        idx = gather_idx.long()
        keep = (idx < bins.shape[0]) & (slot >= 0)
        rows, s = idx[keep], slot[keep]
        bins_rows = bins[rows]
        w = torch.stack([grad[rows], hess[rows], cnt[rows]], dim=1)
        n_cells = num_slots
    G = bins_rows.shape[1]
    g = torch.arange(G, device=s.device)
    cell = ((s[:, None] * G + g[None, :]) * max_bins
            + bin_values(bins_rows).long()).reshape(-1)
    vals = w[:, None, :].expand(-1, G, -1).reshape(-1, 3).contiguous()
    out = torch.zeros((n_cells * G * max_bins, 3), dtype=torch.float32,
                      device=s.device)
    return out, cell, vals


def time_hist_launches(name, items):
    """Device time of each captured launch of one kernel (``device_ms``),
    its plain version's (CUDA events, one call), its bound, and one
    ``index_add_`` call over the same (row, group) pairs: means over the
    launches."""
    from lightgbm_torch.kernels import hist_sorted as hs, hist_wide as hw
    from lightgbm_torch.kernels import scatter_hist as sh
    kernel, plain = {
        "scatter_hist": (sh.scatter_hist_cuda, sh.scatter_hist_plain),
        "hist_direct": (hs.hist_direct_cuda, hs.hist_sorted_plain),
        "hist_nibble": (hs.hist_nibble_cuda, hs.hist_sorted_plain),
        "hist_wide": (hw.hist_wide_cuda, hw.hist_wide_plain)}[name]
    ms, plain_ms, lib_ms, bnd = [], [], [], []
    for args, out in items:
        ms.append(device_ms(lambda a=args: kernel(*a)))
        plain_ms.append(cuda_ms(lambda a=args: plain(*a), reps=1, warmup=0))
        acc, cell, vals = index_add_inputs(name, args)
        lib_ms.append(device_ms(lambda: acc.index_add_(0, cell, vals)))
        del acc, cell, vals
        bnd.append(bound(*hist_work(name, args, out)))
    mean = statistics.mean
    return {"launches_timed": len(items), "ms": ms, "mean_ms": mean(ms),
            "plain_ms": plain_ms, "mean_plain_ms": mean(plain_ms),
            "index_add_ms": lib_ms, "mean_index_add_ms": mean(lib_ms),
            "bound_ms": [b for b, _ in bnd],
            "mean_bound_ms": mean(b for b, _ in bnd),
            "bound_by": bnd[0][1]}


def phase_train_backends(seed, rows, ds63, Xs, ys, smi, iters=10,
                         timed_tree=2):
    """The non-stream growth path at full width: the full phase's 1M rows
    (and the same rows binned at max_bin 255) trained through
    ``lightgbm_torch.train`` with ``hist_backend`` scatter (K5) and pallas
    (K6 at max_bin 63, K7 at 255): binary, 255 leaves, learning rate 0.1,
    split budget 64, ``iters`` iterations.  The kernel counts are read
    around each ``train`` call (its kernel launched, K2 never); scatter and
    pallas must grow byte-identical text at each max_bin, and a second run
    must repeat it, and then one more iteration of it is timed phase by
    phase; held-out AUC > 0.80 through ``Booster.predict``; every K5/K6/K7
    launch of one tree is replayed bit-equal through its plain version and
    timed beside its bound and the ``index_add_`` call.
    Returns the K5, K6 and K7 entries of the kernels line and the replays'
    largest differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels

    t0 = time.perf_counter()
    X, y = make_higgs_like(rows, 28, seed)
    ds255 = lt.Dataset(X, label=y, params={"max_bin": 255}).construct()
    binning_s = time.perf_counter() - t0
    del X
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "max_splits_per_round": 64, "verbosity": -1}
    record, launches, caps, err = {}, {k: 0 for k in HIST_KERNELS}, {}, {}
    for mb, ds in ((63, ds63), (255, ds255)):
        texts = {}
        for hb in ("scatter", "pallas"):
            want = "scatter_hist" if hb == "scatter" else \
                sorted_kernel(ds.device_data().max_bins)
            params = {**base, "max_bin": mb, "hist_backend": hb}
            kernels.reset_launch_counts()
            with TimedIters(capture_at=timed_tree) as timed:
                t0 = time.perf_counter()
                bst = lt.train(params, ds, iters)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
            if (bst.num_trees() != iters or counts[want] == 0
                    or counts["route_and_hist"] != 0
                    or counts["leaf_gather"] != iters):
                raise RuntimeError(f"{hb} at max_bin {mb}: {bst.num_trees()} "
                                   f"trees with launches {counts}")
            launches[want] += counts[want]
            caps[(mb, hb)] = (want, timed.cap)
            texts[hb] = model_trees_text(bst)
            again = lt.train(params, ds, iters)
            if model_trees_text(again) != texts[hb]:
                raise RuntimeError(f"{hb} at max_bin {mb} does not repeat "
                                   f"bit for bit")
            prof_s, prof_phases, prof_reads = profiled_iteration(again)
            record[f"{hb}_{mb}"] = {
                "profiled_iteration_s": prof_s,
                "profiled_iteration_phases_s": prof_phases,
                "profiled_iteration_host_reads": prof_reads,
                "train_s": train_s, "tree_s": timed.seconds,
                "s_per_tree": statistics.median(timed.seconds[1:]),
                "launches": counts,
                "hist_launches_per_tree": counts[want] / iters,
                "leaves_per_tree": [t.num_leaves for t in bst.engine.models],
                "max_bins": ds.device_data().max_bins}
        if texts["scatter"] != texts["pallas"]:
            raise RuntimeError(f"max_bin {mb}: scatter and pallas grow "
                               f"different trees")
        pred = bst.predict(Xs)
        held_auc = auc(ys, pred)
        if not (np.isfinite(pred).all() and held_auc > 0.80):
            raise RuntimeError(f"max_bin {mb}: held-out AUC {held_auc}")
        record[f"held_out_auc_{mb}"] = held_auc
    del ds255
    timing = {}
    for (mb, hb), (name, cap) in caps.items():
        replayed, e = replay_against_plain(cap)
        if replayed[name] == 0 or replayed["route_and_hist"] != 0:
            raise RuntimeError(f"{hb} at max_bin {mb}: replayed {replayed}")
        err[name] = max(err.get(name, 0.0), e[name])
        hist_calls = cap.k5 if hb == "scatter" else cap.k67
        timing[f"{name}_{mb}"] = time_hist_launches(name, hist_calls)
        timing[f"{name}_{mb}"]["replayed"] = replayed[name]
        caps[(mb, hb)] = None
    emit({"phase": "train_backends", "card": smi, "rows": rows,
          "features": 28, "iterations": iters, "num_leaves": 255,
          "binning_255_s": binning_s, "runs": record,
          "text_identical_scatter_pallas": True,
          "determinism_identical": True, "replay_max_abs_err": err,
          "timed_tree": timed_tree, "kernel_times": timing})
    lines = []
    for name, key in (("scatter_hist", "scatter_hist_63"),
                      ("hist_direct", "hist_direct_63"),
                      ("hist_nibble", "hist_nibble_255")):
        t = timing[key]
        lines.append({"name": name, "route": "cuda",
                      "source": KERNEL_SOURCES[name],
                      "replaces": KERNEL_REPLACES[name],
                      "launches": launches[name], "max_abs_err": err[name],
                      "ms": t["mean_ms"], "plain_ms": t["mean_plain_ms"],
                      "bound_ms": t["mean_bound_ms"],
                      "bound_by": t["bound_by"],
                      "library_ms": t["mean_index_add_ms"]})
    # K5 runs at both max_bins; its entry's own numbers are max_bin 63's
    lines[0]["by_max_bin"] = {
        str(mb): {k: timing[f"scatter_hist_{mb}"][f"mean_{k}"]
                  for k in ("ms", "plain_ms", "bound_ms")}
        | {"library_ms": timing[f"scatter_hist_{mb}"]["mean_index_add_ms"],
           "launches_timed": timing[f"scatter_hist_{mb}"]["launches_timed"]}
        for mb in (63, 255)}
    return lines, err


def bin_dtype(Bmax):
    """The host bins' dtype at Bmax: uint8, or uint16 (16-bit bins, held
    on the card as int16 storage) past 256 bins."""
    return np.uint8 if Bmax <= 256 else np.uint16


def bins_tensor(bins, dev):
    """Host bins (uint8 or uint16) as a flat tensor of their card storage
    on ``dev``."""
    from lightgbm_torch.kernels.layout import bins_to_torch
    return bins_to_torch(np.ascontiguousarray(bins).reshape(-1)).to(dev)


def hist_adversarial_inputs(seed, n, G, K, S, Bmax, kind="random",
                            offset=0):
    """Operands of one K5 (K = 0) or K8 launch on the card, made with numpy
    from ``seed``: (G, N) bins, (K, N) slots (half the rows in a slot),
    N(0, 1) grads, hesses in [0.01, 1), 0/1 counts.  ``kind``: "one_cell"
    puts every row in slot 0 and bin 0; "edge" also makes every weight
    +-1.5 or 1.5, so that at the shift hist_shift picks the sums reach
    2**61; "negative" puts no row in any slot.  ``offset`` > 0 hands the
    kernel views that start that many elements into their storage, so no
    operand is 16-byte aligned (the kernel's scalar row path)."""
    import torch
    from lightgbm_torch.ops.histogram import hist_shift

    rs = np.random.RandomState(seed)
    kk = max(K, 1)
    bins = rs.randint(0, Bmax, size=(G, n + offset)).astype(bin_dtype(Bmax))
    slot = np.where(rs.rand(kk, n + offset) < 0.5,
                    rs.randint(0, S, size=(kk, n + offset)), -1)
    grad = rs.randn(kk, n + offset).astype(np.float32)
    hess = rs.uniform(0.01, 1.0, size=(kk, n + offset)).astype(np.float32)
    cnt = (rs.rand(n + offset) < 0.9).astype(np.float32)
    if kind in ("one_cell", "edge"):
        bins[:] = 0
        slot[:] = 0
    if kind == "edge":
        grad = np.where(grad < 0, -1.5, 1.5).astype(np.float32)
        hess[:] = 1.5
        cnt[:] = 1.0
    if kind == "negative":
        slot = -1 - rs.randint(0, 4, size=slot.shape)
    shifts = [hist_shift(float(max(np.abs(grad[k]).max(initial=0.0),
                                   np.abs(hess[k]).max(initial=0.0))), n)
              for k in range(kk)]
    dev = torch.device("cuda")
    # each operand a contiguous view ``offset`` elements into its storage
    bins_t = bins_tensor(bins, dev)[offset:offset + G * n].view(G, n)
    flat = [torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(dev)
            [offset:offset + kk * n].view(kk, n)
            for x in (slot.astype(np.int32), grad, hess)]
    cnt_t = torch.from_numpy(cnt).to(dev)[offset:offset + n]
    slot_t, grad_t, hess_t = flat
    if K == 0:
        return (bins_t, slot_t[0], grad_t[0], hess_t[0], cnt_t, S, Bmax,
                shifts[0])
    return (bins_t, slot_t, grad_t, hess_t, cnt_t, S, Bmax, shifts)


# (label, kernel, n, G, K (0: K5's single-class call), S, Bmax, kind,
# operand offset)
HIST_ADVERSARIAL = (
    ("k5_root_one_cell", "scatter_hist", 1_000_000, 28, 0, 1, 63,
     "one_cell", 0),
    ("k5_edge_weights", "scatter_hist", 1_000_000, 28, 0, 1, 255, "edge", 0),
    ("k5_s64_b255", "scatter_hist", 1_000_000, 28, 0, 64, 255, "random", 0),
    ("k5_s64_b63", "scatter_hist", 1_000_000, 28, 0, 64, 63, "random", 0),
    ("k5_g1", "scatter_hist", 100_003, 1, 0, 7, 256, "random", 0),
    ("k5_n1", "scatter_hist", 1, 28, 0, 3, 63, "random", 0),
    ("k5_n0", "scatter_hist", 0, 28, 0, 3, 63, "random", 0),
    ("k5_negative", "scatter_hist", 50_000, 28, 0, 16, 63, "negative", 0),
    ("k5_unaligned_ragged", "scatter_hist", 250_001, 28, 0, 13, 255,
     "random", 1),
    ("k8_k10_s64_b63", "hist_wide", 900_000, 28, 10, 64, 63, "random", 0),
    ("k8_k10_s64_b255", "hist_wide", 900_000, 28, 10, 64, 255, "random", 0),
    ("k8_root_one_cell", "hist_wide", 900_000, 28, 10, 1, 63, "one_cell", 0),
    ("k8_edge_weights", "hist_wide", 900_000, 28, 10, 1, 63, "edge", 0),
    ("k8_g1", "hist_wide", 100_002, 1, 3, 33, 2, "random", 0),
    ("k8_n1", "hist_wide", 1, 28, 10, 64, 255, "random", 0),
    ("k8_n0", "hist_wide", 0, 28, 10, 64, 63, "random", 0),
    ("k8_negative", "hist_wide", 50_000, 28, 10, 64, 63, "negative", 0),
    ("k8_unaligned_ragged", "hist_wide", 250_001, 28, 3, 21, 200, "random",
     3),
    # 16-bit bins: just past 256, the Flight Delay bundles' width, bin
    # tiles (K5/K8's 20-byte cells tile past 11 622 bins), bins past 32 767
    ("k5_wide_b257", "scatter_hist", 1_000_000, 8, 0, 64, 257, "random", 0),
    ("k5_wide_b1524_s64", "scatter_hist", 500_000, 3, 0, 64, 1524,
     "random", 0),
    ("k5_wide_b14529_bin_tiles", "scatter_hist", 200_000, 3, 0, 16, 14_529,
     "random", 0),
    ("k5_wide_b40000", "scatter_hist", 200_000, 2, 0, 4, 40_000, "random",
     0),
    ("k5_wide_one_cell", "scatter_hist", 200_000, 3, 0, 1, 1524,
     "one_cell", 0),
    ("k5_wide_n1", "scatter_hist", 1, 3, 0, 3, 1524, "random", 0),
    ("k5_wide_n0", "scatter_hist", 0, 3, 0, 3, 1524, "random", 0),
    ("k5_wide_unaligned_ragged", "scatter_hist", 250_001, 3, 0, 13, 1524,
     "random", 1),
    ("k8_wide_k10_b1524", "hist_wide", 300_000, 3, 10, 16, 1524, "random",
     0),
    ("k8_wide_b40000", "hist_wide", 100_000, 2, 3, 4, 40_000, "random", 0),
    ("k8_wide_n1", "hist_wide", 1, 3, 10, 16, 1524, "random", 0),
    ("k8_wide_unaligned_ragged", "hist_wide", 100_003, 3, 3, 7, 300,
     "random", 3),
)


def k2_adversarial_inputs(seed, n, G, K, S, Bmax, kind, int_form,
                          offset=0):
    """Arguments of one K2 launch with histograms on the card (the float
    form's, or with ``int_form`` the int form's), made with numpy from
    ``seed``.  Route records: leaves 0 .. S/2 - 1 split on a random group
    at a random bin (rows to slots 2j and 2j + 1), a leaf that keeps slot
    S - 1 when S is odd, and a leaf without a slot; leaf ids at random.
    Weights: N(0, 1) grads and hesses in [0.01, 1) (int form: grid values
    in [-127, 127] and [0, 127]), 0/1 counts.  ``kind``: "routes" gives the
    split leaves EFB-bundled features, NaN and zero-as-missing bins with
    either default direction, and categorical splits with random bitsets;
    "one_cell" puts every row in one leaf that keeps slot 0, every bin 0;
    "edge" also makes every weight the largest the form takes (float: +-1.5
    and 1.5, so that at the shift hist_shift picks the sums reach 2**61;
    int: -127 and 127); "negative" puts no row in any slot.  ``offset`` > 0
    hands the kernel views that start that many elements into their
    storage, so that no operand is 16-byte aligned."""
    import torch
    from lightgbm_torch.kernels import layout as tl
    from lightgbm_torch.ops.histogram import hist_shift, scale_table

    rs = np.random.RandomState(seed)
    m = n + offset
    W = (Bmax + 31) // 32
    half = S // 2
    keep_odd = S % 2 == 1
    L = half + int(keep_odd) + 1
    tabs = np.zeros((K, L, len(tl.ROUTE_FIELDS)), np.int32)
    words = rs.randint(-2 ** 31, 2 ** 31, size=(K, L, W)).astype(np.int32)
    tabs[:, :, tl.R_NANBIN] = -1
    tabs[:, :, tl.R_MZBIN] = -1
    tabs[:, :, tl.R_NBINS] = Bmax
    j = np.arange(half)
    tabs[:, :half, tl.R_CHOSEN] = 1
    tabs[:, :half, tl.R_NEWID] = rs.randint(0, L, size=(K, half))
    tabs[:, :half, tl.R_GROUP] = rs.randint(0, G, size=(K, half))
    tabs[:, :half, tl.R_THR] = rs.randint(0, Bmax, size=(K, half))
    tabs[:, :half, tl.R_SLOT_L] = 2 * j
    tabs[:, :half, tl.R_SLOT_R] = 2 * j + 1
    if keep_odd:
        tabs[:, half, tl.R_SLOT_KEEP] = S - 1
    tabs[:, L - 1, tl.R_SLOT_KEEP] = -1
    if kind == "routes":
        shape = (K, half)
        nb = rs.randint(2, Bmax + 1, size=shape)
        bundled = rs.rand(*shape) < 0.4
        tabs[:, :half, tl.R_BUNDLED] = bundled
        tabs[:, :half, tl.R_NBINS] = np.where(bundled, nb, Bmax)
        tabs[:, :half, tl.R_SPAN] = np.where(
            bundled, rs.randint(0, Bmax, size=shape), 0)
        tabs[:, :half, tl.R_DEFBIN] = rs.randint(0, Bmax, size=shape) % nb
        tabs[:, :half, tl.R_NANBIN] = np.where(
            rs.rand(*shape) < 0.5, rs.randint(0, Bmax, size=shape), -1)
        tabs[:, :half, tl.R_MZBIN] = np.where(
            rs.rand(*shape) < 0.5, rs.randint(0, Bmax, size=shape), -1)
        tabs[:, :half, tl.R_DEFLEFT] = rs.rand(*shape) < 0.5
        tabs[:, :half, tl.R_ISCAT] = rs.rand(*shape) < 0.3
    bins = rs.randint(0, Bmax, size=(G, m)).astype(bin_dtype(Bmax))
    leaf = rs.randint(0, L, size=(K, m)).astype(np.int32)
    if kind in ("one_cell", "edge"):
        bins[:] = 0
        leaf[:] = L - 1
        tabs[:, L - 1, tl.R_SLOT_KEEP] = 0
    if kind == "negative":
        tabs[:, :, tl.R_SLOT_L] = -1
        tabs[:, :, tl.R_SLOT_R] = -2
        tabs[:, :, tl.R_SLOT_KEEP] = -1
    cnt = (rs.rand(m) < 0.9).astype(np.float32)
    if int_form:
        grad = rs.randint(-127, 128, size=(K, m)).astype(np.int8)
        hess = rs.randint(0, 128, size=(K, m)).astype(np.int8)
        if kind == "edge":
            grad[:] = -127
            hess[:] = 127
    else:
        grad = rs.randn(K, m).astype(np.float32)
        hess = rs.uniform(0.01, 1.0, size=(K, m)).astype(np.float32)
        if kind == "edge":
            grad = np.where(grad < 0, -1.5, 1.5).astype(np.float32)
            hess[:] = 1.5
    dev = torch.device("cuda")

    def rows_view(x):
        # a contiguous (K, n) or (G, n) view ``offset`` elements into its
        # storage (16-bit bins in int16 storage)
        x = np.ascontiguousarray(x)
        t = torch.from_numpy((x.view(np.int16) if x.dtype == np.uint16
                              else x).reshape(-1)).to(dev)
        return t[offset:offset + x.shape[0] * n].view(x.shape[0], n)

    bins_t, leaf_t, grad_t, hess_t = (rows_view(x)
                                      for x in (bins, leaf, grad, hess))
    cnt_t = torch.from_numpy(cnt).to(dev)[offset:offset + n]
    tabs_t = torch.from_numpy(tabs).to(dev)
    words_t = torch.from_numpy(words).to(dev)
    if int_form:
        return (bins_t, leaf_t, tabs_t, words_t, grad_t, hess_t, cnt_t, S,
                Bmax, True)
    g, h = grad_t.float().cpu().numpy(), hess_t.float().cpu().numpy()
    shifts = tuple(hist_shift(float(max(np.abs(g[k]).max(initial=0.0),
                                        np.abs(h[k]).max(initial=0.0))), n)
                   for k in range(K))
    return (bins_t, leaf_t, tabs_t, words_t, grad_t, hess_t, cnt_t, S, Bmax,
            shifts, True, scale_table(shifts, dev))


# (label, n, G, K, S, Bmax, kind, operand offset), each run through both
# forms of K2 (the int form's gate case alone through the int form)
K2_ADVERSARIAL = (
    ("k1_one_cell", 1_000_000, 28, 1, 1, 63, "one_cell", 0),
    ("k10_one_cell", 900_000, 28, 10, 1, 63, "one_cell", 0),
    ("k1_edge_weights", 1_000_000, 28, 1, 1, 255, "edge", 0),
    ("k10_edge_weights", 900_000, 28, 10, 1, 63, "edge", 0),
    ("k1_s64_b255", 1_000_000, 28, 1, 64, 255, "random", 0),
    ("k10_s64_b255", 900_000, 28, 10, 64, 255, "random", 0),
    ("k10_s64_b63", 900_000, 28, 10, 64, 63, "random", 0),
    ("k1_routes", 200_000, 28, 1, 63, 256, "routes", 0),
    ("k10_routes", 100_000, 28, 10, 33, 200, "routes", 0),
    ("k1_g1", 100_003, 1, 1, 7, 256, "random", 0),
    ("k3_g1", 100_002, 1, 3, 33, 2, "random", 0),
    ("k1_n1", 1, 28, 1, 3, 63, "random", 0),
    ("k10_n1", 1, 28, 10, 64, 255, "random", 0),
    ("k1_n0", 0, 28, 1, 3, 63, "random", 0),
    ("k10_n0", 0, 28, 10, 64, 63, "random", 0),
    ("k1_negative", 50_000, 28, 1, 16, 63, "negative", 0),
    ("k10_negative", 50_000, 28, 10, 64, 63, "negative", 0),
    ("k1_unaligned_ragged", 250_001, 28, 1, 13, 255, "routes", 1),
    ("k3_unaligned_ragged", 250_001, 28, 3, 21, 200, "routes", 3),
    # 16-bit bins: just past 256, the Flight Delay bundles' width, bin
    # tiles (16-byte cells tile past 14 528 bins, the int form's 8-byte
    # ones past 29 056), bins past 32 767, EFB spans past 256
    ("k1_wide_b257", 500_000, 8, 1, 64, 257, "routes", 0),
    ("k1_wide_b1524", 500_000, 3, 1, 64, 1524, "routes", 0),
    ("k1_wide_b14529_bin_tiles", 200_000, 3, 1, 16, 14_529, "random", 0),
    ("k1_wide_b40000", 100_000, 2, 1, 4, 40_000, "routes", 0),
    ("k10_wide_b1524", 200_000, 3, 10, 16, 1524, "routes", 0),
    ("k1_wide_one_cell", 200_000, 3, 1, 1, 1524, "one_cell", 0),
    ("k1_wide_n1", 1, 3, 1, 3, 1524, "routes", 0),
    ("k1_wide_n0", 0, 3, 1, 3, 1524, "random", 0),
    ("k3_wide_unaligned_ragged", 250_001, 3, 3, 13, 1524, "routes", 3),
)
# the int form at its caller's gate (half * N < 2**31): 2**31 // 127 rows
# of -127 and 127 in one cell
K2_INT_GATE = ("k1_int32_gate", 2 ** 31 // 127, 1, 1, 1, 1, "edge", 0)


def k6_adversarial_inputs(seed, n, G, S, Bmax, kind, T, offset=0):
    """Arguments of one K6 launch on the card, made with numpy from
    ``seed``: (N, G) row-major bins, the slot-sorted block plan of T
    positions (ops/compact.py; its trailing pad blocks gather only the pad
    row) of half the rows in S slots, N(0, 1) grads, hesses in [0.01, 1),
    0/1 counts.  ``kind``: "one_slot" puts every row in slot S - 1;
    "edge" every row in slot 0 (the root's plan) and bin 0 with weights
    +-1.5 and 1.5, so that at the shift hist_shift picks the sums reach
    2**61; "single_rows" one row in each of S - 1 slots and none in the
    last; "top_bin" every bin Bmax - 1.  Past 256 bins the bins are 16-bit
    (int16 storage).  ``offset`` > 0 hands the kernel views that start that
    many elements into their storage, so that no operand is 16-byte
    aligned."""
    import torch
    from lightgbm_torch.ops.compact import plan_blocks, plan_single_slot
    from lightgbm_torch.ops.histogram import hist_shift

    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, size=(n, G)).astype(bin_dtype(Bmax))
    slot = np.where(rs.rand(n) < 0.5, rs.randint(0, S, size=n),
                    -1).astype(np.int32)
    grad = rs.randn(n).astype(np.float32)
    hess = rs.uniform(0.01, 1.0, size=n).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    if kind == "one_slot":
        slot[:] = S - 1
    elif kind == "edge":
        bins[:] = 0
        slot[:] = 0
        grad = np.where(grad < 0, -1.5, 1.5).astype(np.float32)
        hess[:] = 1.5
        cnt[:] = 1.0
    elif kind == "single_rows":
        slot[:] = -1
        slot[rs.choice(n, size=min(n, S - 1), replace=False)] = \
            np.arange(min(n, S - 1))
    elif kind == "top_bin":
        bins[:] = Bmax - 1
    shift = hist_shift(float(max(np.abs(grad).max(initial=0.0),
                                 np.abs(hess).max(initial=0.0))), n)
    dev = torch.device("cuda")
    plan = (plan_single_slot(n, T, dev) if kind == "edge" or n == 0
            else plan_blocks(torch.from_numpy(slot).to(dev), S, T))

    def view(x):
        # a contiguous view ``offset`` elements into its storage
        flat = (bins_tensor(x, dev) if x is bins else
                torch.as_tensor(np.ascontiguousarray(x)).reshape(-1).to(dev))
        t = torch.cat([flat[:offset], flat]) if offset else flat
        return t[offset:].view(x.shape)

    return (view(bins), view(plan.gather_idx.cpu().numpy()),
            plan.scalars, view(grad), view(hess), view(cnt), S, Bmax, shift,
            T)


# (label, n, G, S, Bmax, kind, block rows T, operand offset)
K6_ADVERSARIAL = (
    ("k6_one_slot", 1_000_000, 28, 64, 64, "one_slot", 1024, 0),
    ("k6_edge_weights", 1_000_000, 28, 1, 64, "edge", 1024, 0),
    ("k6_single_rows", 100_000, 28, 64, 64, "single_rows", 1024, 0),
    ("k6_s64_b64", 1_000_000, 28, 64, 64, "random", 1024, 0),
    ("k6_s16_b128", 500_000, 28, 16, 128, "random", 1024, 0),
    ("k6_group_tiles", 100_000, 300, 8, 128, "random", 1024, 0),
    ("k6_g1", 100_003, 1, 7, 2, "random", 1024, 0),
    ("k6_n1", 1, 28, 3, 63, "random", 1024, 0),
    ("k6_n0", 0, 28, 3, 63, "random", 1024, 0),
    ("k6_unaligned_ragged", 250_001, 27, 13, 100, "random", 999, 1),
)


# K7's cases through the same inputs: Bmax 129 / 200 / 255 / 256, the root
# and 64 slots, every row in one cell, pad blocks (every plan's trailing
# blocks), unaligned operands and G not a multiple of 4
K7_ADVERSARIAL = (
    ("k7_one_slot", 1_000_000, 28, 64, 255, "one_slot", 1024, 0),
    ("k7_edge_weights", 1_000_000, 28, 1, 255, "edge", 1024, 0),
    ("k7_root_b256", 1_000_000, 28, 1, 256, "edge", 1024, 0),
    ("k7_single_rows", 100_000, 28, 64, 256, "single_rows", 1024, 0),
    ("k7_s64_b255", 1_000_000, 28, 64, 255, "random", 1024, 0),
    ("k7_s1_b129", 1_000_000, 28, 1, 129, "random", 1024, 0),
    ("k7_s16_b256", 500_000, 28, 16, 256, "random", 1024, 0),
    ("k7_group_tiles", 100_000, 300, 8, 200, "random", 1024, 0),
    ("k7_g1", 100_003, 1, 7, 130, "random", 1024, 0),
    ("k7_n1", 1, 28, 3, 255, "random", 1024, 0),
    ("k7_n0", 0, 28, 3, 255, "random", 1024, 0),
    ("k7_g27_unaligned_ragged", 250_001, 27, 13, 255, "random", 999, 1),
    # 16-bit bins: Bmax 257, 301 (the Flight Delay cell's) and 1525, the
    # top bin, slots with no rows, 64 slots, a bin-tiled plan (a group of
    # more than 11 622 bins: one group a tile, a range of bins), unaligned
    ("k7_wide_b257", 500_000, 8, 16, 257, "random", 1024, 0),
    ("k7_wide_b301_s64", 1_000_000, 8, 64, 301, "random", 1024, 0),
    ("k7_wide_b301_root", 500_000, 8, 1, 301, "edge", 1024, 0),
    ("k7_wide_b1525_top_bin", 300_000, 3, 16, 1525, "top_bin", 1024, 0),
    ("k7_wide_b1525_single_rows", 100_000, 3, 64, 1525, "single_rows",
     1024, 0),
    ("k7_wide_bin_tiles", 200_000, 3, 8, 40_000, "random", 1024, 0),
    ("k7_wide_bin_tiles_top_bin", 100_000, 2, 4, 12_000, "top_bin", 1024,
     0),
    ("k7_wide_unaligned_ragged", 250_001, 9, 13, 700, "random", 999, 1),
    ("k7_wide_n1", 1, 8, 3, 301, "random", 1024, 0),
)


def k3_records(rs, R, L, G, Bmax, kind="grown"):
    """(R, L, 16) int32 route records of R growth rounds, made with numpy
    from ``rs``: each round splits about 0.7 of the leaves so far (while
    ids below L remain) on a random group at a random bin, the right child
    a new id, default direction at random.  ``kind``: "missing" gives half
    the splits a NaN bin and half a zero-as-missing bin; "routes" also
    EFB-bundles 0.4 of them and puts thresholds below 0 and past 255;
    "out_of_range" sends 0.25 of the right children outside [0, L);
    "narrow_thr" draws the thresholds and the NaN and zero bins below 256
    whatever Bmax (over 16-bit bins: records the kernel packs, not special
    ones)."""
    from lightgbm_torch.kernels import layout as tl

    tabs = np.zeros((R, L, len(tl.ROUTE_FIELDS)), np.int32)
    tabs[..., tl.R_NANBIN] = -1
    tabs[..., tl.R_MZBIN] = -1
    tabs[..., tl.R_NBINS] = Bmax
    cur = 1
    for r in range(R):
        split = np.flatnonzero(rs.rand(cur) < 0.7)[:max(L - cur, 0)]
        k = len(split)
        rec = tabs[r]
        rec[split, tl.R_CHOSEN] = 1
        rec[split, tl.R_NEWID] = cur + np.arange(k)
        rec[split, tl.R_GROUP] = rs.randint(0, G, k)
        rec[split, tl.R_THR] = rs.randint(0, Bmax, k)
        rec[split, tl.R_DEFLEFT] = rs.rand(k) < 0.5
        if kind in ("missing", "routes", "narrow_thr"):
            top = min(Bmax, 256) if kind == "narrow_thr" else Bmax
            rec[split, tl.R_NANBIN] = np.where(
                rs.rand(k) < 0.5, rs.randint(0, top, k), -1)
            rec[split, tl.R_MZBIN] = np.where(
                rs.rand(k) < 0.5, rs.randint(0, top, k), -1)
        if kind == "narrow_thr":
            rec[split, tl.R_THR] = rs.randint(0, min(Bmax, 256), k)
        if kind == "routes":
            nb = rs.randint(2, Bmax + 1, k)
            bundled = rs.rand(k) < 0.4
            rec[split, tl.R_BUNDLED] = bundled
            rec[split, tl.R_NBINS] = np.where(bundled, nb, Bmax)
            rec[split, tl.R_SPAN] = np.where(bundled,
                                             rs.randint(0, Bmax, k), 0)
            rec[split, tl.R_DEFBIN] = rs.randint(0, Bmax, k) % nb
            u = rs.rand(k)
            rec[split, tl.R_THR] = np.where(
                u < 0.05, -1, np.where(u > 0.95, 300, rec[split, tl.R_THR]))
        if kind == "out_of_range":
            bad = rs.rand(k) < 0.25
            rec[split, tl.R_NEWID] = np.where(
                bad, np.where(rs.rand(k) < 0.5, L + rs.randint(0, 3, k),
                              -1 - rs.randint(0, 3, k)),
                rec[split, tl.R_NEWID])
        cur += k
    return tabs


def k3_adversarial_inputs(seed, n, G, R, L, Bmax, kind, offset=0):
    """Arguments of one K3 launch on the card, made with numpy from
    ``seed``: the (G, N) bins (uniform below Bmax) and ``k3_records``'
    (R, L, 16) records.  ``offset`` > 0 hands the kernel a bins view that
    starts that many bytes into its storage, so that it is not 16-byte
    aligned."""
    import torch

    rs = np.random.RandomState(seed)
    tabs = k3_records(rs, R, L, G, Bmax, kind)
    bins = rs.randint(0, Bmax, size=(G, n + offset)).astype(bin_dtype(Bmax))
    dev = torch.device("cuda")
    flat = bins_tensor(bins, dev)
    return (flat[offset:offset + G * n].view(G, n),
            torch.from_numpy(tabs).to(dev))


# (label, n, G, R, L, Bmax, kind, bins offset): the main path's shape, EFB
# / NaN / zero-as-missing records, children outside [0, L), R = 0, 1 and
# 17, tables too large for shared memory (16 383 leaves), 3000 groups, N =
# 1, N = 0, and a ragged unaligned N
K3_ADVERSARIAL = (
    ("k3_grown", 1_000_000, 28, 9, 255, 255, "grown", 0),
    ("k3_missing", 200_000, 28, 9, 255, 63, "missing", 0),
    ("k3_routes", 200_000, 28, 9, 255, 256, "routes", 0),
    ("k3_out_of_range", 100_000, 28, 9, 255, 63, "out_of_range", 0),
    ("k3_r0", 100_000, 28, 0, 255, 63, "grown", 0),
    ("k3_r1", 100_000, 28, 1, 2, 63, "grown", 0),
    ("k3_r17_l16383", 250_000, 28, 17, 16383, 255, "routes", 0),
    ("k3_g3000", 100_000, 3000, 9, 255, 63, "missing", 0),
    ("k3_g3000_l16383", 50_000, 3000, 17, 16383, 63, "grown", 0),
    ("k3_n1", 1, 28, 9, 255, 63, "routes", 0),
    ("k3_n0", 0, 28, 9, 255, 63, "grown", 0),
    ("k3_unaligned_ragged", 250_001, 27, 9, 255, 200, "routes", 1),
    # 16-bit bins: thresholds and missing bins past 255 (special records),
    # records packed over bins past 255 (the clamped compare), bins past
    # 32 767
    ("k3_wide_routes", 500_000, 8, 9, 255, 1524, "routes", 0),
    ("k3_wide_narrow_thr", 500_000, 8, 9, 255, 1524, "narrow_thr", 0),
    ("k3_wide_b40000", 200_000, 3, 9, 255, 40_000, "missing", 0),
    ("k3_wide_n1", 1, 3, 9, 255, 1524, "routes", 0),
    ("k3_wide_unaligned_ragged", 250_001, 5, 9, 255, 700, "routes", 1),
)


def phase_hist_adversarial(seed):
    """K5, K8 and both forms of K2 launched on synthetic inputs that stress
    the tile pass's plan and arithmetic (one cell taking every row, weights
    at the shift's edge and, for K2's int form, at the int32 gate's, S = 64
    at Bmax 255, K = 10 x S = 64 over several pair tiles, G = 1, N = 1,
    N = 0, no row in a slot, a ragged end and unaligned operands; for K2
    also EFB, NaN, zero-as-missing and categorical route records); K6 and
    K7 over block plans (``K6_ADVERSARIAL``, ``K7_ADVERSARIAL``) and K3
    over route records (``K3_ADVERSARIAL``), each held bit-equal to its
    plain version on the same tensors; every list also has 16-bit cases
    (Bmax 257, 1524, past the tiles' shared memory, 40 000).  Outside any
    main path's launch counts.  Returns the largest differences by kernel
    (K2 over K > 1 classes as ``route_and_hist_k`` and
    ``route_and_hist_int_k``; the 16-bit cases also as ``<name>_wide``)."""
    import torch
    from lightgbm_torch.kernels import hist_wide as hw, route_hist as rh
    from lightgbm_torch.kernels import scatter_hist as sh

    fns = {"scatter_hist": (sh.scatter_hist_cuda, sh.scatter_hist_plain),
           "hist_wide": (hw.hist_wide_cuda, hw.hist_wide_plain)}
    err = {"scatter_hist": 0.0, "hist_wide": 0.0, "route_and_hist": 0.0,
           "route_and_hist_k": 0.0, "route_and_hist_int": 0.0,
           "route_and_hist_int_k": 0.0}
    cases = {}
    for i, (label, name, n, G, K, S, Bmax, kind, off) in \
            enumerate(HIST_ADVERSARIAL):
        args = hist_adversarial_inputs(seed + i, n, G, K, S, Bmax, kind, off)
        kernel, plain = fns[name]
        out = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        diff = max_abs_diff(out, want)
        err[name] = max(err[name], diff)
        if Bmax > 256:
            err[name + "_wide"] = max(err.get(name + "_wide", 0.0), diff)
        if not (torch.equal(out, want) and torch.isfinite(out).all()):
            raise RuntimeError(f"{label}: {name} differs from its plain "
                               f"version (max abs {diff})")
        cases[label] = {"kernel": name, "rows": n, "groups": G,
                        "classes": max(K, 1), "slots": S, "max_bins": Bmax,
                        "kind": kind, "operand_offset": off,
                        "plan": list(hw.hist_plan(n, G, max(K, 1), S,
                                                  Bmax)),
                        "max_abs_err": diff}
        del args, out, want
    k2_cases = [(c, f) for c in K2_ADVERSARIAL for f in (False, True)]
    k2_cases.append((K2_INT_GATE, True))
    for i, ((label, n, G, K, S, Bmax, kind, off), int_form) in \
            enumerate(k2_cases):
        args = k2_adversarial_inputs(seed + 100 + i, n, G, K, S, Bmax, kind,
                                     int_form, off)
        name = "route_and_hist_int" if int_form else "route_and_hist"
        kernel, plain = ((rh.route_and_hist_int_cuda,
                          rh.route_and_hist_int_plain) if int_form else
                         (rh.route_and_hist_cuda, rh.route_and_hist_plain))
        out = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        diff = max(max_abs_diff(x, y) for x, y in zip(out, want))
        key = name + ("_k" if K > 1 else "")
        err[key] = max(err[key], diff)
        if Bmax > 256:
            err[name + "_wide"] = max(err.get(name + "_wide", 0.0), diff)
        if not (all(torch.equal(x, y) for x, y in zip(out, want))
                and torch.isfinite(out[1].float()).all()):
            raise RuntimeError(f"{label}: {name} differs from its plain "
                               f"version (max abs {diff})")
        cell = rh.INT_CELL_BYTES if int_form else rh.CELL_BYTES
        cases[f"{name}_{label}"] = {
            "kernel": name, "rows": n, "groups": G, "classes": K,
            "slots": S, "max_bins": Bmax, "kind": kind,
            "operand_offset": off,
            "plan": list(hw.hist_plan(n, G, K, S, Bmax, cell)),
            "rows_in_a_slot": float(out[2].sum().item()),
            "max_abs_err": diff}
        del args, out, want
    from lightgbm_torch.kernels import hist_sorted as hs
    from lightgbm_torch.kernels import route_replay as rr
    err["hist_direct"] = err["hist_nibble"] = 0.0
    for i, (label, n, G, S, Bmax, kind, T, off) in \
            enumerate(K6_ADVERSARIAL + K7_ADVERSARIAL):
        args = k6_adversarial_inputs(seed + 200 + i, n, G, S, Bmax, kind, T,
                                     off)
        name = sorted_kernel(Bmax)
        kernel = hs.hist_direct_cuda if name == "hist_direct" \
            else hs.hist_nibble_cuda
        out = kernel(*args)
        want = hs.hist_sorted_plain(*args)
        torch.cuda.synchronize()
        diff = max_abs_diff(out, want)
        err[name] = max(err[name], diff)
        if Bmax > 256:
            err[name + "_wide"] = max(err.get(name + "_wide", 0.0), diff)
        if not (torch.equal(out, want) and torch.isfinite(out).all()):
            raise RuntimeError(f"{label}: {name} differs from its plain "
                               f"version (max abs {diff})")
        cases[label] = {"kernel": name, "rows": n, "groups": G,
                        "slots": S, "max_bins": Bmax, "kind": kind,
                        "block_rows": T, "operand_offset": off,
                        "plan": list(hs.sorted_plan(args[2].shape[0], T, S,
                                                    G, Bmax)),
                        "rows_counted": float(want[..., 2].sum().item()),
                        "max_abs_err": diff}
        del args, out, want
    if not any(cases[c[0]]["plan"][7] > 1 for c in K7_ADVERSARIAL):
        raise RuntimeError("no K7 case ran a bin-tiled plan")
    err["route_replay"] = 0.0
    forms = set()
    for i, (label, n, G, R, L, Bmax, kind, off) in \
            enumerate(K3_ADVERSARIAL):
        bins_T, tabs = k3_adversarial_inputs(seed + 300 + i, n, G, R, L,
                                             Bmax, kind, off)
        out = rr.route_replay_cuda(bins_T, tabs)
        want = rr.route_replay_plain(bins_T, tabs)
        torch.cuda.synchronize()
        diff = max_abs_diff(out, want)
        err["route_replay"] = max(err["route_replay"], diff)
        if Bmax > 256:
            err["route_replay_wide"] = max(err.get("route_replay_wide", 0.0),
                                           diff)
        if not torch.equal(out, want):
            raise RuntimeError(f"{label}: route_replay differs from its "
                               f"plain version (max abs {diff})")
        plan = rr.replay_plan(n, G, R, L) if n else None
        if plan is not None:
            forms.add(plan.tab_bytes > 0)
        packed = rr.pack_records(tabs, G, bins_T.dtype == torch.int16)
        cases[label] = {"kernel": "route_replay", "rows": n, "groups": G,
                        "rounds": R, "leaves": L, "max_bins": Bmax,
                        "kind": kind, "bins_offset": off,
                        "plan": None if plan is None else list(plan),
                        "special_records": int(
                            (packed[..., 1] < 0).sum().item()),
                        "rows_stopped": int((want < 0).sum().item()),
                        "distinct_leaves": int(torch.unique(want).numel()),
                        "max_abs_err": diff}
        del bins_T, tabs, out, want
    if forms != {True, False}:
        raise RuntimeError(f"K3's cases staged the table {forms}, not both "
                           f"staged and in global memory")
    torch.cuda.empty_cache()
    emit({"phase": "hist_adversarial", "cases": cases,
          "all_bit_equal": True, "max_abs_err": err})
    return err


def k1_records(rs, T, L, G, words, kinds=(), chain=False, leaves=None,
               max_bin=256):
    """(T, L, 16) int32 node records (kernels/predict.NODE_FIELDS) of T
    random trees grown as random_tree grows them (``chain``: each node
    sends its left child to a leaf, a path L - 1 deep), and each tree's
    depth.  ``leaves``: each tree's leaf count (default L; 1: a single-leaf
    tree, all-zero records); numeric thresholds below ``max_bin``.
    ``kinds`` mixes in NaN and zero bins ("nan"), EFB-bundled features
    ("efb") and categorical bitsets ("cat", their words appended to
    ``words``)."""
    from lightgbm_torch.kernels import predict as tpk

    rec = np.zeros((T, L, len(tpk.NODE_FIELDS)), np.int32)
    depths = []
    for t in range(T):
        ni = (leaves[t] if leaves else L) - 1
        depth, parent = {0: 0}, {0: None}   # leaf -> depth, (node, side)
        open_leaves = [0]
        for s in range(ni):
            if chain:
                leaf = s
                open_leaves.remove(s)
            else:
                j = rs.randint(len(open_leaves))
                leaf = open_leaves[j]
                open_leaves[j] = open_leaves[-1]
                open_leaves.pop()
            d = depth.pop(leaf)
            if parent[leaf] is not None:
                rec[t, parent[leaf][0], parent[leaf][1]] = s
            rec[t, s, tpk.F_LEFT] = L + leaf
            rec[t, s, tpk.F_RIGHT] = L + s + 1
            parent[leaf], parent[s + 1] = (s, tpk.F_LEFT), (s, tpk.F_RIGHT)
            depth[leaf], depth[s + 1] = d + 1, d + 1
            open_leaves += [leaf, s + 1]
            r = rec[t, s]
            r[tpk.F_GROUP] = rs.randint(G)
            r[tpk.F_THR] = rs.randint(max_bin)
            r[tpk.F_DEFLEFT] = rs.rand() < 0.5
            u = rs.rand()
            if "cat" in kinds and u < 0.2:
                nb = rs.randint(2, 256)
                r[tpk.F_ISCAT], r[tpk.F_NBINS] = 1, nb
                r[tpk.F_CATBASE] = len(words)
                # a bit for every bin value below max_bin (at least a byte)
                words.extend(rs.randint(0, 2 ** 32,
                                        size=max(8, -(-max_bin // 32)),
                                        dtype=np.uint64).tolist())
            elif "efb" in kinds and u < 0.5:
                nb = rs.randint(2, 57)
                r[tpk.F_BUNDLED], r[tpk.F_NBINS] = 1, nb
                r[tpk.F_SPAN] = rs.randint(200)
                r[tpk.F_DEFBIN] = rs.randint(nb)
                r[tpk.F_THR] = rs.randint(nb)
            if "nan" in kinds:
                for has, b in ((tpk.F_HASNAN, tpk.F_NANBIN),
                               (tpk.F_HASMZ, tpk.F_MZBIN)):
                    if rs.rand() < 0.5:
                        r[has], r[b] = 1, rs.randint(256)
        depths.append(max(max(depth.values()), 1))
    return rec, depths


# (label, N, G, classes, T, L, kinds, chain, early stop (freq, margin) or
# None, depth bound or None (the trees' own), bins view offset)
K1_ADVERSARIAL = (
    ("predict_kinds", 200_001, 28, 1, 60, 255, ("nan", "efb", "cat"),
     False, None, None, 0),
    ("predict_early_stop", 100_000, 28, 1, 40, 255, ("nan", "efb"), False,
     (3, 0.4), None, 0),
    ("predict_big_trees", 50_000, 28, 1, 3, 16383, ("nan", "efb", "cat"),
     False, None, None, 0),
    ("predict_huge_trees", 20_000, 28, 1, 2, 40_000, ("nan",), False, None,
     None, 0),
    ("predict_chain_63", 100_000, 28, 1, 10, 64, ("nan",), True, None,
     None, 0),
    ("predict_chain_cut_at_9", 100_000, 28, 1, 10, 64, ("nan",), True,
     None, 9, 0),
    ("predict_single_leaf", 30_000, 28, 1, 12, 31, ("nan",), False, None,
     None, 0),
    ("predict_k3", 60_000, 28, 3, 20, 63, ("nan", "efb", "cat"), False,
     None, None, 0),
    ("predict_n1", 1, 28, 1, 20, 255, ("nan", "efb", "cat"), False, None,
     None, 0),
    ("predict_wide_g", 20_000, 3000, 1, 10, 63, ("nan",), False, None,
     None, 0),
    ("predict_all_global", 20_000, 300, 1, 2, 16383, ("nan", "efb", "cat"),
     False, None, None, 0),
    ("predict_unaligned_ragged", 100_003, 28, 1, 30, 255, ("nan", "efb"),
     False, (7, 1.0), None, 1),
)


def k1_wide_records(rs, T, L, G, words, kinds, Bmax):
    """``k1_records`` over 16-bit bins below Bmax, then a third of the
    numeric nodes with a threshold past 32 767 and a quarter with a NaN bin
    past 510 where Bmax reaches them: wide nodes, special, read from their
    own planes."""
    from lightgbm_torch.kernels import predict as tpk
    rec, depths = k1_records(rs, T, L, G, words, kinds, max_bin=Bmax)
    inner = np.zeros(rec.shape[:2], bool)
    inner[:, :L - 1] = True
    num = inner & (rec[..., tpk.F_BUNDLED] == 0) & (rec[..., tpk.F_ISCAT]
                                                    == 0)
    if Bmax > 32_768:
        hi = num & (rs.rand(*inner.shape) < 0.33)
        rec[..., tpk.F_THR] = np.where(
            hi, rs.randint(32_768, Bmax, inner.shape), rec[..., tpk.F_THR])
    if Bmax > 511:
        nan = num & (rs.rand(*inner.shape) < 0.25)
        rec[..., tpk.F_HASNAN] = np.where(nan, 1, rec[..., tpk.F_HASNAN])
        rec[..., tpk.F_NANBIN] = np.where(
            nan, rs.randint(511, Bmax, inner.shape), rec[..., tpk.F_NANBIN])
    return rec, depths


# 16-bit bins: (label, N, G, classes, T, L, kinds, Bmax, bins view offset)
# -- the Flight Delay bundles' width, thresholds and bins past 32 767, K =
# 3, N = 1, bins and trees in global memory, a ragged unaligned N
K1_WIDE_ADVERSARIAL = (
    ("predict_wide_b1524", 200_001, 8, 1, 60, 255, ("nan", "efb", "cat"),
     1524, 0),
    ("predict_wide_b40000", 100_000, 4, 1, 30, 255, ("nan", "efb"), 40_000,
     0),
    ("predict_wide_k3", 60_000, 8, 3, 20, 63, ("nan", "efb", "cat"), 1524,
     0),
    ("predict_wide_n1", 1, 8, 1, 20, 255, ("nan", "efb"), 40_000, 0),
    ("predict_wide_bins_global", 20_000, 3000, 1, 10, 63, ("nan",), 700, 0),
    ("predict_wide_trees_global", 50_000, 8, 1, 3, 16383, ("nan", "efb"),
     40_000, 0),
    ("predict_wide_all_global", 20_000, 300, 1, 2, 16383, ("nan",), 1524,
     0),
    ("predict_wide_unaligned_ragged", 100_003, 8, 1, 30, 255,
     ("nan", "efb"), 1524, 1),
)


def phase_predict_adversarial(seed):
    """K1 launched on synthetic models and bins made from ``--seed``
    (outside any main path's launch counts), each class's scores held
    bit-equal to the plain version: NaN, zero, EFB and categorical nodes,
    early stop, trees of 16383 leaves (too large for a stage: walk words
    read from global memory) and of 40 000 (children past 16 bits: every
    node special), a chain 63 deep and the same cut by a depth bound
    of 9 (rows past it resolve to leaf 0), single-leaf trees, K = 3 class
    tables, N = 1, a ragged N, 3000 groups (bins read from global memory),
    16383-leaf trees over 300 groups (trees and bins both in global
    memory) and a bins view that is not 16-byte aligned; then 16-bit bins
    (``K1_WIDE_ADVERSARIAL``: thresholds and bins past 32 767, NaN bins
    past 510, Bmax 1524).  Every form of the kernel (trees staged or not x
    bins staged or not) runs at both widths.  Returns the largest
    differences, the 16-bit cases' also as ``predict_stream_wide``."""
    import torch
    from lightgbm_torch.kernels import predict as tpk

    dev = torch.device("cuda")
    cases, err, forms = {}, 0.0, set()
    for i, (label, n, G, K, T, L, kinds, chain, es, cut, off) in \
            enumerate(K1_ADVERSARIAL):
        plan = tpk.predict_plan(n, G, L, T)
        forms.add((plan.trees_per_stage > 0, plan.bins_stride > 0))
        rs = np.random.RandomState(seed + 300 + i)
        bins = rs.randint(0, 256, size=G * n + off).astype(np.uint8)
        bins_T = torch.from_numpy(bins).to(dev)[off:].view(G, n)
        es_freq, margin = es or (0, 0.0)
        for k in range(K):
            words = []
            leaves = ([1 if t % 3 == 1 else L for t in range(T)]
                      if label == "predict_single_leaf" else None)
            rec, depths = k1_records(rs, T, L, G, words, kinds, chain, leaves)
            if cut:
                depths = [cut] * T
            nodes = torch.from_numpy(tpk.pack_nodes(rec)).to(dev)
            lv = torch.from_numpy(rs.uniform(-0.1, 0.1, size=(T, L))
                                  .astype(np.float32)).to(dev)
            wt = torch.from_numpy(np.asarray(words or [0], np.uint64)
                                  .astype(np.uint32).view(np.int32)).to(dev)
            got = tpk.predict_stream_cuda(bins_T, nodes, lv, wt, max(depths),
                                          es_freq, margin)
            want = tpk.predict_stream_plain(bins_T, nodes, lv, wt, depths,
                                            es_freq, margin)
            torch.cuda.synchronize()
            diff = max_abs_diff(got, want)
            err = max(err, diff)
            if not (torch.equal(got, want) and torch.isfinite(got).all()):
                raise RuntimeError(f"{label} class {k}: predict_stream "
                                   f"differs from its plain version (max "
                                   f"abs {diff})")
        cases[label] = {"rows": n, "groups": G, "classes": K, "trees": T,
                        "num_leaves": L, "kinds": list(kinds),
                        "max_depth": max(depths), "early_stop": es,
                        "bins_offset": off,
                        "plan": plan._asdict(), "max_abs_err": diff}
        del bins_T, nodes, lv, wt, got, want
    wide_err, wide_forms = 0.0, set()
    for i, (label, n, G, K, T, L, kinds, Bmax, off) in \
            enumerate(K1_WIDE_ADVERSARIAL):
        plan = tpk.predict_plan(n, G, L, T, 2)
        wide_forms.add((plan.trees_per_stage > 0, plan.bins_stride > 0))
        rs = np.random.RandomState(seed + 400 + i)
        bins = rs.randint(0, Bmax, size=G * n + off).astype(np.uint16)
        # a quarter of the rows' bins past 32 767 where Bmax reaches it
        if Bmax > 32_768:
            bins[:G * n // 4] = rs.randint(32_768, Bmax, G * n // 4)
        bins_T = bins_tensor(bins, dev)[off:].view(G, n)
        wide_nodes = 0
        for k in range(K):
            words = []
            rec, depths = k1_wide_records(rs, T, L, G, words, kinds, Bmax)
            packed = tpk.pack_nodes(rec)
            wide_nodes += int((((packed[tpk.PACKED_WORDS.index("flags")]
                                 .view(np.uint32) >> tpk.WIDE_BIT) & 1)
                               > 0).sum())
            nodes = torch.from_numpy(packed).to(dev)
            lv = torch.from_numpy(rs.uniform(-0.1, 0.1, size=(T, L))
                                  .astype(np.float32)).to(dev)
            wt = torch.from_numpy(np.asarray(words or [0], np.uint64)
                                  .astype(np.uint32).view(np.int32)).to(dev)
            got = tpk.predict_stream_cuda(bins_T, nodes, lv, wt, max(depths))
            want = tpk.predict_stream_plain(bins_T, nodes, lv, wt, depths)
            torch.cuda.synchronize()
            diff = max_abs_diff(got, want)
            wide_err = max(wide_err, diff)
            if not (torch.equal(got, want) and torch.isfinite(got).all()):
                raise RuntimeError(f"{label} class {k}: predict_stream "
                                   f"differs from its plain version over "
                                   f"16-bit bins (max abs {diff})")
        cases[label] = {"rows": n, "groups": G, "classes": K, "trees": T,
                        "num_leaves": L, "kinds": list(kinds),
                        "max_bins": Bmax, "wide_nodes": wide_nodes,
                        "bins_offset": off, "plan": plan._asdict(),
                        "max_abs_err": diff}
        del bins_T, nodes, lv, wt, got, want
    torch.cuda.empty_cache()
    if len(forms) != 4 or len(wide_forms) != 4:
        raise RuntimeError(f"K1's adversarial cases ran the kernel forms "
                           f"(trees staged, bins staged) {sorted(forms)}, "
                           f"16-bit {sorted(wide_forms)}, not all four")
    emit({"phase": "predict_adversarial", "cases": cases,
          "all_bit_equal": True, "max_abs_err": err,
          "max_abs_err_wide": wide_err})
    return {"predict_stream": max(err, wide_err),
            "predict_stream_wide": wide_err}


# --------------------------------------------------------------------------
# multiclass training
# --------------------------------------------------------------------------

def make_multiclass_like(n, f, k=10, seed=17):
    """Synthetic K-class softmax task: 28 continuous features, linear class
    logits plus a shared nonlinear confusion term (the generator of
    bench.py, copied)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    W = rs.randn(f, k).astype(np.float32) * 0.9
    logits = X @ W
    logits += (0.8 * np.sin(3 * X[:, :1]) + 0.6 * X[:, 1:2] * X[:, 2:3])
    y = np.argmax(logits + rs.randn(n, k).astype(np.float32) * 0.8,
                  axis=1).astype(np.float64)
    return X, y


def dyadic_mc_fobj(score, ds):
    """(N, K) custom gradients on a 1/64 grid and hessians on a 1/32 grid
    from the (N, K) score and the class labels: every sum of them is exact
    in float32."""
    oh = np.eye(score.shape[1], dtype=np.float32)[
        ds.get_label().astype(np.int64)]
    g = np.clip(np.round(64.0 * (score - oh)) / 64.0, -127 / 64, 127 / 64)
    h = 0.5 + np.round(16.0 * np.abs(g)) / 32.0
    return g.astype(np.float32), h.astype(np.float32)


def phase_train_multiclass_small(seed, n=20_000, iters=5, num_leaves=127,
                                 sampled_iters=3):
    """Multiclass training (K = 3) on both devices: dyadic custom gradients
    under stream, scatter and pallas must give byte-identical text on the
    CPU and the card; on the card the lockstep and per-class paths must
    give identical text on real softmax gradients under each backend; every
    K2 (K > 1) and K8 launch of the card's lockstep runs is
    replayed bit-equal through its plain version.  Under bagging and GOSS
    (``sampled_iters`` iterations, learning rate 1: GOSS samples from the
    second): dyadic text equal on the CPU and the card under stream and
    scatter (compaction auto, pad, off) and pallas, lockstep equal to
    per-class and fused equal to eager on the card's real gradients, a
    quantized bagged arm CPU == card; every card launch of the compacted
    K-class rows (K2 both forms, route-only passes, K8) replayed."""
    import torch
    import lightgbm_torch as lt

    X, _ = make_train_small(n, seed)
    rs = np.random.RandomState(seed + 11)
    logits = np.stack([np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1],
                       2.0 * X[:, 2] - 1.5 * X[:, 3], X[:, 4] * X[:, 5]], 1)
    y = np.argmax(logits + rs.randn(n, 3), axis=1).astype(np.float64)
    base = {"objective": "multiclass", "num_class": 3,
            "num_leaves": num_leaves, "max_splits_per_round": 64,
            "max_bin": 63, "verbosity": -1}
    out, cap = {}, Capture()
    for hb in ("stream", "scatter", "pallas"):
        texts = []
        for dev in ("cpu", "cuda"):
            p = {**base, "hist_backend": hb, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
            for _ in range(iters):
                bst.update(fobj=dyadic_mc_fobj)
            texts.append(model_trees_text(bst))
        if texts[0] != texts[1]:
            raise RuntimeError(f"{hb}: dyadic multiclass training differs "
                               f"between CPU and card")
        real = []
        for batched in (True, False):
            p = {**base, "hist_backend": hb, "multiclass_batched": batched,
                 "device_type": "cuda"}
            with (cap if batched else contextlib.nullcontext()):
                real.append(lt.train(p, lt.Dataset(X, label=y, params=p),
                                     iters))
        if model_trees_text(real[0]) != model_trees_text(real[1]):
            raise RuntimeError(f"{hb}: lockstep and per-class multiclass "
                               f"training differ on the card")
        out[hb] = {"dyadic_leaves_per_tree": [t.num_leaves
                                              for t in bst.engine.models],
                   "real_leaves_per_tree": [t.num_leaves
                                            for t in real[0].engine.models]}
    # the fused lockstep iteration, its graphs replayed, against the eager
    # one on the card (softmax rounds differently on the CPU)
    pair = [lt.train(p, lt.Dataset(X, label=y, params=p), iters)
            for p in ({**base, "fused_iter": fused, "device_type": "cuda"}
                      for fused in ("on", "off"))]
    if (model_trees_text(pair[0]) != model_trees_text(pair[1])
            or pair[0].engine._graphs.replays == 0):
        raise RuntimeError("multiclass: fused and eager lockstep differ")
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not (replayed["route_and_hist_k"] and replayed["hist_wide"]):
        raise RuntimeError(f"the multiclass runs replayed {replayed}")
    sampled, s_replayed, s_err = multiclass_sampled_small(
        X, y, base, sampled_iters)
    err = {k: max(v, s_err[k]) for k, v in err.items()}
    emit({"phase": "train_multiclass_small", "rows": n, "classes": 3,
          "iterations": iters, "num_leaves": num_leaves, "runs": out,
          "dyadic_text_identical_cpu_card": True,
          "lockstep_per_class_identical": True,
          "fused_eager_identical_card": True,
          "replayed_launches": replayed, "sampled": sampled,
          "sampled_iterations": sampled_iters,
          "replayed_launches_sampled": s_replayed,
          "replay_max_abs_err": err})
    return err


def multiclass_sampled_small(X, y, base, iters):
    """phase_train_multiclass_small's sampled arms (see there): (per-arm
    results, launches replayed, largest differences)."""
    import torch
    import lightgbm_torch as lt

    cap = Capture()
    out = {}
    pad, off = {"row_compaction": "pad"}, {"row_compaction": "off"}
    for kind in ("bagging", "goss"):
        sp = {**sampled_params(kind), "learning_rate": 1.0}
        res = {}
        for sched, runs in (
                ("stream", [("cpu", "stream", {}), ("cuda", "stream", {}),
                            ("cuda", "stream", pad),
                            ("cuda", "stream", off)]),
                ("plain", [("cpu", "scatter", {}), ("cuda", "scatter", {}),
                           ("cuda", "scatter", pad),
                           ("cuda", "scatter", off),
                           ("cuda", "pallas", {})])):
            texts, compact = [], []
            for dev, hb, extra in runs:
                p = {**base, **sp, **extra, "hist_backend": hb,
                     "device_type": dev}
                bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
                with (cap if dev == "cuda" and not extra
                      else contextlib.nullcontext()):
                    for _ in range(iters):
                        bst.update(fobj=dyadic_mc_fobj)
                texts.append(model_trees_text(bst))
                compact.append(bst.engine.last_compact_rows)
            if any(t != texts[0] for t in texts):
                raise RuntimeError(f"{kind} {sched}: sampled multiclass "
                                   f"training differs "
                                   f"{[t == texts[0] for t in texts]}")
            # auto compacts on both devices, off and pallas do not
            if not (compact[0] > 0 and compact[1] > 0 and compact[3] == 0
                    and compact[-1] == 0):
                raise RuntimeError(f"{kind} {sched}: compaction {compact}")
            res[sched] = {"runs": [f"{d} {hb} {e}" for d, hb, e in runs],
                          "compact_rows": compact,
                          "leaves_per_tree": [t.num_leaves
                                              for t in bst.engine.models]}
        # real softmax gradients on the card: lockstep == per-class, the
        # fused iteration (graphs replayed) == eager
        real = {}
        for name, extra in (("lockstep", {}),
                            ("per_class", {"multiclass_batched": False}),
                            ("eager", {"fused_iter": "off"})):
            p = {**base, **sp, **extra, "device_type": "cuda"}
            with (cap if name == "lockstep" else contextlib.nullcontext()):
                real[name] = lt.train(p, lt.Dataset(X, label=y, params=p),
                                      iters)
        lock = model_trees_text(real["lockstep"])
        if not (real["lockstep"].engine._fused
                and not real["per_class"].engine._fused
                and not real["eager"].engine._fused):
            raise RuntimeError(f"{kind}: the real-gradient arms' fusion")
        if any(model_trees_text(b) != lock for b in real.values()):
            raise RuntimeError(f"{kind}: lockstep, per-class and eager "
                               f"sampled multiclass training differ")
        res["real_lockstep_per_class_fused_eager_identical"] = True
        res["real_compact_rows"] = real["lockstep"].engine.last_compact_rows
        out[kind] = res
    # quantized K = 3 bagged, power-of-two-scaled dyadic gradients: CPU ==
    # card through K2's int form over the compacted rows
    q_texts = []
    for dev in ("cpu", "cuda"):
        p = {**base, **sampled_params("bagging"), "learning_rate": 0.5,
             "use_quantized_grad": True, "device_type": dev}
        bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
        with (cap if dev == "cuda" else contextlib.nullcontext()):
            for _ in range(iters):
                bst.update(fobj=pow2_mc_fobj)
        q_texts.append(model_trees_text(bst))
    if q_texts[0] != q_texts[1] or not bst.engine.last_compact_rows:
        raise RuntimeError("quantized bagged multiclass: CPU and card "
                           "differ, or no compaction")
    out["quantized_bagging"] = {"text_identical_cpu_card": True,
                                "compact_rows": bst.engine.last_compact_rows}
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not all(replayed[k] for k in ("route_and_hist_k",
                                     "route_and_hist_int_k", "hist_wide",
                                     "leaf_gather")):
        raise RuntimeError(f"the sampled multiclass runs replayed "
                           f"{replayed}")
    return out, replayed, err


def k2k_index_add_inputs(args):
    """The flattened (class, slot, group, bin) cell of every (row, class,
    group) triple a K2 launch adds to a histogram, with its (grad, hess),
    for the library call ``index_add_`` (float32, not exact; for the int
    form int32, exact), and its zeroed (K * S * G * Bmax, 2) output.  The
    slots are the plain route's (the routing has no library call)."""
    import torch
    from lightgbm_torch.kernels.layout import bin_values
    from lightgbm_torch.kernels.route_hist import route_plain

    bins_T, leaf_id, tabs, words, grad, hess, cnt, num_slots, max_bins = \
        args[:9]
    K = leaf_id.shape[0]
    slot = torch.stack([route_plain(bins_T, leaf_id[k], tabs[k], words[k])[1]
                        for k in range(K)])
    slot = torch.where(cnt[None, :] > 0, slot, -1)
    kk, rows = torch.nonzero(slot >= 0, as_tuple=True)
    s = kk * num_slots + slot[kk, rows].long()
    G = bins_T.shape[0]
    g = torch.arange(G, device=s.device)
    cell = ((s[:, None] * G + g[None, :]) * max_bins
            + bin_values(bins_T[:, rows].t()).long()).reshape(-1)
    # the int form's int8 grid values add as int32, its result type
    w = torch.stack([grad[kk, rows], hess[kk, rows]], dim=1)
    w = w.to(torch.int32 if grad.dtype == torch.int8 else torch.float32)
    vals = w[:, None, :].expand(-1, G, -1).reshape(-1, 2).contiguous()
    acc = torch.zeros((K * num_slots * G * max_bins, 2), dtype=w.dtype,
                      device=s.device)
    return acc, cell, vals


def phase_train_multiclass(seed, smi, rows=1_000_000, iters=10,
                           held_out=100_000, per_class_iters=5,
                           timed_iter=2, quant_iters=5, sampled_iters=10):
    """The multiclass cell at full width (bench.py's make_multiclass_like,
    28 features, K = 10): 255 leaves, max_bin 63, learning rate 0.1, split
    budget 64, ``iters`` iterations under stream (K2 over K > 1 classes),
    then pallas and scatter (K8, byte-identical to each other); a
    per-class arm and a binary probe on ``y % 2``; held-out top-1 accuracy
    through ``Booster.predict``; one iteration's K2 and K8 launches
    replayed bit-equal and timed; a quantized arm (``use_quantized_grad``,
    ``quant_iters`` lockstep iterations through K2's int form over the K
    classes, held-out accuracy > 0.3, one iteration's launches replayed
    and timed, one more iteration timed phase by phase); a bagged arm
    (fraction 0.8 every iteration) and a GOSS arm (rates 0.2 / 0.1,
    learning rate 0.5: sampled from the third iteration), each
    ``sampled_iters`` fused iterations on one compacted view of the K
    classes (``multiclass_sampled_arm``); the K-class route-only passes
    (the unsampled sprint, the sampled trees' every round, float and int
    forms) timed beside their bounds.  Returns the K2 (K > 1) and K8
    entries of the kernels line and the replays' largest differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels

    del seed                    # the cell's data has bench.py's own seed
    K = 10
    t0 = time.perf_counter()
    X, y = make_multiclass_like(rows, 28, K, seed=17)
    Xtr, ytr = X[:rows - held_out], y[:rows - held_out]
    Xte, yte = X[rows - held_out:], y[rows - held_out:]
    ds = lt.Dataset(Xtr, label=ytr, params={"max_bin": 63}).construct()
    binning_s = time.perf_counter() - t0
    base = {"objective": "multiclass", "num_class": K, "num_leaves": 255,
            "max_bin": 63, "learning_rate": 0.1, "max_splits_per_round": 64,
            "verbosity": -1}
    from lightgbm_torch.utils.timer import host_reads

    runs, texts, caps = {}, {}, {}
    for hb in ("stream", "pallas", "scatter"):
        want = "route_and_hist" if hb == "stream" else "hist_wide"
        other = "hist_wide" if hb == "stream" else "route_and_hist"
        kernels.reset_launch_counts()
        r0 = host_reads()
        with TimedIters(capture_at=min(timed_iter, iters - 1)) as timed:
            t0 = time.perf_counter()
            bst = lt.train({**base, "hist_backend": hb}, ds, iters)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        reads = host_reads() - r0
        counts = kernels.launch_counts()
        if (bst.num_trees() != iters * K or counts[want] == 0
                or counts[other] != 0 or counts["leaf_gather"] != iters):
            raise RuntimeError(f"multiclass {hb}: {bst.num_trees()} trees "
                               f"with launches {counts}")
        texts[hb] = model_trees_text(bst)
        caps[hb] = timed.cap
        runs[hb] = {"train_s": train_s, "iter_s": timed.seconds,
                    "s_per_iter": statistics.median(timed.seconds[1:]),
                    "launches": counts,
                    "hist_launches_per_iter": counts[want] / iters,
                    "leaves_per_tree": [t.num_leaves
                                        for t in bst.engine.models]}
        if hb == "stream":
            stream_bst, stream_counts = bst, counts
            stream_timed, stream_reads = timed, reads
    if texts["pallas"] != texts["scatter"]:
        raise RuntimeError("multiclass: pallas and scatter grow different "
                           "trees")
    # held-out top-1 accuracy through Booster.predict (K1, one launch per
    # class)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prob = stream_bst.predict(Xte)
    predict_s = time.perf_counter() - t0
    k1_launches = kernels.launch_counts()["predict_stream"]
    acc = float(np.mean(np.argmax(prob, axis=1) == yte))
    if not (prob.shape == (held_out, K) and np.isfinite(prob).all()
            and acc > 0.5 and k1_launches == K):
        raise RuntimeError(f"multiclass held-out accuracy {acc}, "
                           f"{k1_launches} K1 launches")
    # the per-class arm: the lockstep run's first iterations, tree for tree
    with TimedIters() as pc:
        per_class = lt.train({**base, "multiclass_batched": False}, ds,
                             per_class_iters)
    if model_trees_text(per_class) != model_trees_text(
            stream_bst, num_iteration=per_class_iters):
        raise RuntimeError("lockstep and per-class multiclass training "
                           "differ")
    # the binary probe on the same rows and leaf budget
    bin_ds = lt.Dataset(Xtr, label=(ytr % 2).astype(np.float64),
                        params={"max_bin": 63})
    with TimedIters() as probe:
        lt.train({**base, "objective": "binary", "num_class": 1}, bin_ds,
                 iters)
    # the fused iteration (stream's main path) against the eager one
    runs["stream"]["fused_iter"] = fused_and_eager(
        stream_bst, stream_timed, stream_counts, stream_reads,
        lambda extra, n: lt.train({**base, "hist_backend": "stream",
                                   **extra}, ds, n), iters)
    s_iter = runs["stream"]["s_per_iter"]
    s_bin = statistics.median(probe.seconds[1:])
    s_pc = statistics.median(pc.seconds[1:])
    prof_s, prof_phases, prof_reads = profiled_iteration(stream_bst)

    # one iteration's launches: replayed against the plain versions, then
    # timed beside their bounds and one index_add_ call
    err = {}
    for hb, cap in caps.items():
        replayed, e = replay_against_plain(cap)
        name = "route_and_hist_k" if hb == "stream" else "hist_wide"
        if replayed[name] == 0:
            raise RuntimeError(f"multiclass {hb}: replayed {replayed}")
        err[name] = max(err.get(name, 0.0), e[name])
        runs[hb]["replayed_launches_timed_iter"] = replayed
    k2k = time_k2_launches([(a, o) for a, o in caps["stream"].k2 if a[10]],
                           False)
    k2k_route = time_k2_launches(
        [(a, o) for a, o in caps["stream"].k2 if not a[10]], False)
    k8 = time_hist_launches("hist_wide", caps["scatter"].k8)
    caps.clear()
    # the int form's class axis: the lockstep iteration with quantized
    # gradients (4 levels, stochastic rounding)
    kernels.reset_launch_counts()
    with TimedIters(capture_at=min(timed_iter, quant_iters - 1)) as qt:
        qbst = lt.train({**base, "use_quantized_grad": True}, ds,
                        quant_iters)
        torch.cuda.synchronize()
    q_counts = kernels.launch_counts()
    if (qbst.num_trees() != quant_iters * K
            or q_counts["route_and_hist_int"] == 0
            or q_counts["route_and_hist"] != 0):
        raise RuntimeError(f"quantized multiclass: {qbst.num_trees()} trees "
                           f"with launches {q_counts}")
    q_prob = qbst.predict(Xte)
    q_acc = float(np.mean(np.argmax(q_prob, axis=1) == yte))
    if not (np.isfinite(q_prob).all() and q_acc > 0.3):
        raise RuntimeError(f"quantized multiclass accuracy {q_acc}")
    q_replayed, q_err = replay_against_plain(qt.cap)
    if not q_replayed["route_and_hist_int_k"]:
        raise RuntimeError(f"quantized multiclass replayed {q_replayed}")
    err["route_and_hist_int_k"] = q_err["route_and_hist_int_k"]
    q_full = time_k2_launches([(a, o) for a, o in qt.cap.k2i if a[9]], True)
    q_route = time_k2_launches([(a, o) for a, o in qt.cap.k2i if not a[9]],
                               True)
    qt_seconds = qt.seconds
    del qt
    q_prof_s, q_prof_phases, q_prof_reads = profiled_iteration(qbst)
    del qbst
    sampled = {}
    for kind, extra in (("bagging", {"bagging_fraction": 0.8,
                                     "bagging_freq": 1}),
                        ("goss", {"data_sample_strategy": "goss",
                                  "learning_rate": 0.5})):
        sampled[kind], e = multiclass_sampled_arm(
            {**base, **extra}, ds, Xte, yte, sampled_iters, timed_iter + 2)
        err["route_and_hist_k"] = max(err["route_and_hist_k"],
                                      e["route_and_hist_k"])
    emit({"phase": "train_multiclass", "card": smi, "rows": rows - held_out,
          "held_out_rows": held_out, "features": 28, "classes": K,
          "iterations": iters, "num_leaves": 255, "binning_s": binning_s,
          "runs": runs, "text_identical_pallas_scatter": True,
          "s_per_iter": s_iter, "s_per_iter_per_class": s_pc,
          "per_class_iter_s": pc.seconds,
          "binary_s_per_tree": s_bin, "binary_tree_s": probe.seconds,
          "ratio_multiclass_to_binary": s_iter / s_bin,
          "ratio_per_class_to_binary": s_pc / s_bin,
          "lockstep_per_class_identical": True,
          "held_out_top1_accuracy": acc, "predict_s": predict_s,
          "k1_launches_predict": k1_launches,
          "profiled_iteration_s": prof_s,
          "profiled_iteration_phases_s": prof_phases,
          "profiled_iteration_host_reads": prof_reads,
          "replay_max_abs_err": err,
          "k2k_full_hist": k2k, "k2k_route_only": k2k_route, "k8": k8,
          "sampled": sampled,
          "quantized": {"iterations": quant_iters, "iter_s": qt_seconds,
                        "s_per_iter": statistics.median(qt_seconds[1:]),
                        "launches": q_counts,
                        "k2_int_launches_per_iter":
                        q_counts["route_and_hist_int"] / quant_iters,
                        "held_out_top1_accuracy": q_acc,
                        "replayed_launches_timed_iter": q_replayed,
                        "k2_int_k_full_hist": q_full,
                        "k2_int_k_route_only": q_route,
                        "profiled_iteration_s": q_prof_s,
                        "profiled_iteration_phases_s": q_prof_phases,
                        "profiled_iteration_host_reads": q_prof_reads}})
    lines = [
        {"name": "route_and_hist_k", "route": "cuda",
         "source": KERNEL_SOURCES["route_and_hist"],
         "replaces": KERNEL_REPLACES["route_and_hist"],
         "launches": stream_counts["route_and_hist"],
         "max_abs_err": err["route_and_hist_k"],
         "ms": k2k["mean_ms"], "plain_ms": k2k["mean_plain_ms"],
         "bound_ms": k2k["mean_bound_ms"], "bound_by": k2k["bound_by"],
         "library_ms": k2k["mean_index_add_ms"],
         "route_only": {"ms": k2k_route["mean_ms"],
                        "bound_ms": k2k_route["mean_bound_ms"],
                        "plain_ms": k2k_route["mean_plain_ms"],
                        "int_ms": q_route["mean_ms"],
                        "int_bound_ms": q_route["mean_bound_ms"]},
         "sampled": {kind: {"launches": a["launches"]["route_and_hist"],
                            "compact_rows": a["compact_rows"],
                            "hist_ms": a["k2k_hist"]["mean_ms"],
                            "hist_bound_ms": a["k2k_hist"]["mean_bound_ms"],
                            "route_only_ms": (a["k2k_route_only"] or {}).get(
                                "mean_ms"),
                            "route_only_bound_ms": (
                                a["k2k_route_only"] or {}).get(
                                    "mean_bound_ms")}
                     for kind, a in sampled.items()}},
        {"name": "hist_wide", "route": "cuda",
         "source": KERNEL_SOURCES["hist_wide"],
         "replaces": KERNEL_REPLACES["hist_wide"],
         "launches": runs["scatter"]["launches"]["hist_wide"]
         + runs["pallas"]["launches"]["hist_wide"],
         "max_abs_err": err["hist_wide"],
         "ms": k8["mean_ms"], "plain_ms": k8["mean_plain_ms"],
         "bound_ms": k8["mean_bound_ms"], "bound_by": k8["bound_by"],
         "library_ms": k8["mean_index_add_ms"]}]
    return lines, err


def multiclass_sampled_arm(params, ds, Xte, yte, iters, timed_iter):
    """One sampled arm of the multiclass cell: ``iters`` fused iterations,
    held-out top-1 accuracy > 0.5, the fused text equal to the eager one,
    and iteration ``timed_iter``'s launches replayed bit-equal and timed.
    Where the in-bag share saves 25 % of the rows (GOSS; not bagging at
    0.8, which grows on masked weights over all rows, as in the
    reference) the K trees grow on one compacted view of the in-bag rows
    and every round adds a K-class route-only pass over all rows: those
    launches are timed apart."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.utils.timer import host_reads

    K = params["num_class"]
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_iter) as timed:
        bst = lt.train(params, ds, iters)
        torch.cuda.synchronize()
    reads = host_reads() - r0
    counts = kernels.launch_counts()
    compacts = "data_sample_strategy" in params
    if (bst.num_trees() != iters * K or counts["route_and_hist"] == 0
            or counts["route_replay"] != 0
            or counts["leaf_gather"] != iters
            or (bst.engine.last_compact_rows > 0) != compacts):
        raise RuntimeError(f"sampled multiclass: {bst.num_trees()} trees, "
                           f"launches {counts}, compaction "
                           f"{bst.engine.last_compact_rows}")
    prob = bst.predict(Xte)
    acc = float(np.mean(np.argmax(prob, axis=1) == yte))
    if not (np.isfinite(prob).all() and acc > 0.5):
        raise RuntimeError(f"sampled multiclass accuracy {acc}")
    fused = fused_and_eager(bst, timed, counts, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    replayed, err = replay_against_plain(timed.cap)
    n_rows = ds.device_data().bins.shape[0]
    hist = [(a, o) for a, o in timed.cap.k2 if a[10]]
    # the route-only passes over all rows: a compacted tree's every round
    # (its sprint also routes the compacted rows), an uncompacted tree's
    # sprint
    route = [(a, o) for a, o in timed.cap.k2
             if not a[10] and a[0].shape[1] == n_rows]
    if not (replayed["route_and_hist_k"] and hist
            and (route or not compacts)
            and all((a[0].shape[1] < n_rows) == compacts for a, _ in hist)):
        raise RuntimeError(f"sampled multiclass replayed {replayed}, "
                           f"{len(hist)} passes with histograms, "
                           f"{len(route)} route-only")
    out = {"iterations": iters, "launches": counts,
           "k2_launches_per_iter": counts["route_and_hist"] / iters,
           "compact_rows": bst.engine.last_compact_rows,
           "sampled_rows": bst.engine.last_sampled_rows,
           "held_out_top1_accuracy": acc, "iter_s": timed.seconds,
           "s_per_iter": statistics.median(timed.seconds[1:]),
           "fused_iter": fused, "replayed_launches_timed_iter": replayed,
           "k2k_hist": time_k2_launches(hist, False),
           "k2k_route_only": (time_k2_launches(route, False) if route
                              else None)}
    return out, err


# --------------------------------------------------------------------------
# quantized-gradient training
# --------------------------------------------------------------------------

def pow2_grid(r):
    """Dyadic gradients whose quantization scales are powers of two: every
    4th row |g| = 1 and h = 1 (the largest of each), the others |g| <= 1/2
    on a 1/64 grid and h = 1/2; GOSS at top 0.5 / other 0.25 amplifies only
    small rows, by 2.  Every grid value and every sum is then exact."""
    big = (np.arange(len(r)) % 4 == 0).reshape((-1,) + (1,) * (r.ndim - 1))
    g = np.where(big, np.where(r >= 0, 1.0, -1.0),
                 np.clip(np.round(32.0 * r) / 64.0, -0.5, 0.5))
    h = np.where(big, 1.0, 0.5) * np.ones_like(r)
    return g.astype(np.float32), h.astype(np.float32)


def pow2_fobj(score, ds):
    return pow2_grid(score - ds.get_label())


def pow2_mc_fobj(score, ds):
    oh = np.eye(score.shape[1])[ds.get_label().astype(np.int64)]
    return pow2_grid(score - oh)


def nan_fobj(bad_call, rows=(3, 50, 700)):
    """Logistic gradients with a constant hessian; the ``bad_call``-th call
    puts NaN in three rows' gradients."""
    calls = [0]

    def fobj(score, ds):
        calls[0] += 1
        g = (1.0 / (1.0 + np.exp(-score)) - ds.get_label()).astype(np.float32)
        h = np.full(len(g), 0.25, np.float32)
        if calls[0] == bad_call:
            g[list(rows)] = np.nan
        return g, h
    return fobj


def phase_train_quantized_small(seed, n=20_000, iters=5, num_leaves=127):
    """Quantized-gradient training on both devices: power-of-two dyadic
    custom gradients must give byte-identical model text on the CPU and the
    card for binary, K = 3 lockstep, GOSS and renewed leaves (every card
    run through K2's int form, the float form never); the nan_guard cases
    on the card (NaN init scores train as zeros; NaN gradients at the 2nd
    of 4 updates make a no-op tree and do not stop training); every K2 int
    launch of the card's runs replayed bit-equal through its plain
    version."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels

    X, y = make_train_small(n, seed)
    rs = np.random.RandomState(seed + 11)
    logits = np.stack([np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1],
                       2.0 * X[:, 2] - 1.5 * X[:, 3], X[:, 4] * X[:, 5]], 1)
    y3 = np.argmax(logits + rs.randn(n, 3), axis=1).astype(np.float64)
    base = {"objective": "none", "num_leaves": num_leaves,
            "max_splits_per_round": 64, "max_bin": 63, "verbosity": -1,
            "use_quantized_grad": True}
    cases = {"binary": ({}, y, pow2_fobj),
             "goss": (sampled_params("goss"), y, pow2_fobj),
             "renew": ({"quant_train_renew_leaf": True}, y, pow2_fobj),
             "multiclass": ({"objective": "multiclass", "num_class": 3}, y3,
                            pow2_mc_fobj)}
    cap, out = Capture(), {}
    for name, (extra, label, fobj) in cases.items():
        texts = []
        for dev in ("cpu", "cuda"):
            p = {**base, **extra, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=label, params=p))
            kernels.reset_launch_counts()
            with (cap if dev == "cuda" else contextlib.nullcontext()):
                for _ in range(iters):
                    bst.update(fobj=fobj)
            texts.append(model_trees_text(bst))
        counts = kernels.launch_counts()
        if not (bst.engine.grow_params.int_hist
                and counts["route_and_hist_int"] > 0
                and counts["route_and_hist"] == 0):
            raise RuntimeError(f"quantized {name}: launches {counts}")
        if texts[0] != texts[1]:
            raise RuntimeError(f"quantized {name}: training differs between "
                               f"CPU and card")
        out[name] = {"leaves_per_tree": [t.num_leaves
                                         for t in bst.engine.models],
                     "k2_int_launches": counts["route_and_hist_int"]}
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not (replayed["route_and_hist_int"]
            and replayed["route_and_hist_int_k"]):
        raise RuntimeError(f"the quantized runs replayed {replayed}")
    # nan_guard on the card
    p = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
         "verbosity": -1, "device_type": "cuda"}
    init = np.zeros(n)
    init[[3, 50, 700]] = np.nan
    guarded = lt.train(p, lt.Dataset(X, label=y, init_score=init, params=p),
                       5)
    clean = lt.train(p, lt.Dataset(X, label=y, init_score=np.nan_to_num(init),
                                   params=p), 5)
    if not (guarded.num_trees() == 5
            and model_trees_text(guarded) == model_trees_text(clean)):
        raise RuntimeError("nan_guard: NaN init scores do not train as "
                           "zeros")
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    fobj = nan_fobj(2)
    rets = [bst.update(fobj=fobj) for _ in range(4)]
    leaves = [t.num_leaves for t in bst.engine.models]
    if rets != [False] * 4 or len(leaves) != 4 or leaves[1] != 1 \
            or min(leaves[:1] + leaves[2:]) < 2:
        raise RuntimeError(f"nan_guard: NaN gradients gave {rets}, {leaves}")
    fused_cpu = fused_against_cpu(X, y, base, iters)
    emit({"phase": "train_quantized_small", "rows": n, "iterations": iters,
          "fused_card_text_equals_eager_cpu": fused_cpu,
          "num_leaves": num_leaves, "runs": out,
          "text_identical_cpu_card": True, "replayed_launches": replayed,
          "replay_max_abs_err": err, "nan_init_trees": guarded.num_trees(),
          "nan_grad_update_returns": rets, "nan_grad_leaves": leaves})
    return err


def phase_train_quantized(ds, Xs, ys, smi, iters=20, timed_tree=2):
    """Quantized-gradient training at full width: the full phase's 1M-row
    Dataset (max_bin 63), binary, 255 leaves, learning rate 0.1, split
    budget 64, ``use_quantized_grad`` at LightGBM's defaults (4 levels,
    stochastic rounding), ``iters`` iterations through
    ``lightgbm_torch.train`` with the kernel counts read around the call
    (K2's int form launched, its float form never); held-out AUC > 0.80
    through ``Booster.predict``; the first 3 trees repeat byte for byte;
    arms with renewed leaves, with 16 levels rounded to nearest, and under
    ``hist_backend="scatter"`` (the grid values through K5, no K2), each
    AUC > 0.80; a bagged arm for the compacted launches; every K2 int
    launch of one timed tree (and of one bagged tree) replayed bit-equal,
    then timed beside its bound and one int32 ``index_add_`` call; one more
    iteration timed phase by phase.  Returns the K2 int entry of the
    kernels line and the replays' largest differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels

    from lightgbm_torch.utils.timer import host_reads

    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "verbosity": -1,
              "use_quantized_grad": True}
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    if (bst.num_trees() != iters or launches["route_and_hist_int"] == 0
            or launches["route_and_hist"] != 0
            or launches["leaf_gather"] != iters):
        raise RuntimeError(f"quantized training made {bst.num_trees()} "
                           f"trees with launches {launches}")
    pred = bst.predict(Xs)
    held_auc = auc(ys, pred)
    if not (np.isfinite(pred).all() and held_auc > 0.80):
        raise RuntimeError(f"quantized: held-out AUC {held_auc}")
    again = lt.train(params, ds, 3)
    if model_trees_text(again) != model_trees_text(bst, num_iteration=3):
        raise RuntimeError("quantized training does not repeat bit for bit")
    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    arms = {}
    for name, extra, want in (
            ("renew", {"quant_train_renew_leaf": True}, "route_and_hist_int"),
            ("bins16_nearest", {"num_grad_quant_bins": 16,
                                "stochastic_rounding": False},
             "route_and_hist_int"),
            ("scatter", {"hist_backend": "scatter"}, "scatter_hist")):
        kernels.reset_launch_counts()
        with TimedIters() as arm_t:
            arm = lt.train({**params, **extra}, ds, iters)
        counts = kernels.launch_counts()
        others = [k for k in ("route_and_hist", "route_and_hist_int")
                  if k != want]
        arm_auc = auc(ys, arm.predict(Xs))
        if (arm.num_trees() != iters or counts[want] == 0
                or any(counts[k] for k in others) or not arm_auc > 0.80):
            raise RuntimeError(f"quantized {name}: {arm.num_trees()} trees, "
                               f"launches {counts}, AUC {arm_auc}")
        arms[name] = {"held_out_auc": arm_auc, "launches": counts,
                      "s_per_tree": statistics.median(arm_t.seconds[1:])}
    # a bagged tree: K2's int form over the compacted rows
    with TimedIters(capture_at=2) as bag_t:
        bag = lt.train({**params, "bagging_fraction": 0.5,
                        "bagging_freq": 1}, ds, 3)
    if not bag.engine.last_compact_rows > 0:
        raise RuntimeError("quantized bagging did not compact")
    replayed, err = replay_against_plain(timed.cap)
    replayed_bag, err_bag = replay_against_plain(bag_t.cap)
    if not (replayed["route_and_hist_int"]
            and replayed_bag["route_and_hist_int"]):
        raise RuntimeError(f"quantized: replayed {replayed}, {replayed_bag}")
    err = {k: max(v, err_bag[k]) for k, v in err.items()}
    k2i = timed.cap.k2i
    full = time_k2_launches([(a, o) for a, o in k2i if a[9]], True)
    route = time_k2_launches([(a, o) for a, o in k2i if not a[9]], True)
    compacted = time_k2_launches([(a, o) for a, o in bag_t.cap.k2i
                                  if a[9]], True)
    profiled_s, phases_s, prof_reads = profiled_iteration(bst)
    tree_s = timed.seconds
    emit({"phase": "train_quantized", "card": smi, "rows": int(ds.num_data()),
          "iterations": iters, "num_leaves": 255, "num_grad_quant_bins": 4,
          "stochastic_rounding": True,
          "leaves_per_tree": [t.num_leaves for t in bst.engine.models],
          "train_s": train_s, "s_per_tree": statistics.median(tree_s[1:]),
          "tree_s": tree_s, "launches": launches,
          "k2_int_launches_per_tree": launches["route_and_hist_int"] / iters,
          "held_out_auc": held_auc, "determinism_first_3_trees_identical":
          True, "arms": arms, "bagged_compact_rows":
          bag.engine.last_compact_rows,
          "replayed_launches_timed_tree": replayed,
          "replayed_launches_bagged_tree": replayed_bag,
          "replay_max_abs_err": err, "k2_int_full_hist": full,
          "k2_int_route_only": route, "k2_int_compacted": compacted,
          "profiled_iteration_s": profiled_s,
          "profiled_iteration_phases_s": phases_s,
          "profiled_iteration_host_reads": prof_reads,
          "fused_iter": fused})
    line = {"name": "route_and_hist_int", "route": "cuda",
            "source": KERNEL_SOURCES["route_and_hist_int"],
            "replaces": KERNEL_REPLACES["route_and_hist_int"],
            "launches": launches["route_and_hist_int"],
            "max_abs_err": err["route_and_hist_int"],
            "ms": full["mean_ms"], "plain_ms": full["mean_plain_ms"],
            "bound_ms": full["mean_bound_ms"], "bound_by": full["bound_by"],
            "library_ms": full["mean_index_add_ms"]}
    return line, err


# --------------------------------------------------------------------------
# categorical training
# --------------------------------------------------------------------------

class KeepGrownTrees:
    """A ``train`` callback that keeps a reference to each iteration's
    grown trees' device arrays (a list append: no copy, no device work),
    so that their split kinds can be counted after ``train`` has moved the
    trees to the host."""

    def __init__(self):
        self.arrays = []

    def __call__(self, env):
        eng = env.model.engine
        self.arrays.extend(e["arrays"] for e in
                           eng._lazy_trees[-eng.num_tree_per_iteration:])


def cat_kinds(arrays):
    """The kinds of categorical split over grown trees' device arrays: the
    trees, those with a categorical node, and the one-hot, sorted (forward)
    and reversed nodes in all and per tree."""
    from lightgbm_torch.ops import split as sp
    per_tree = []
    for a in arrays:
        d = a.dir_flags[:max(int(a.num_leaves) - 1, 0)].cpu().numpy()
        cat = (d & sp.DIR_CATEGORICAL) != 0
        oh = cat & ((d & sp.DIR_CAT_ONEHOT) != 0)
        rev = cat & ((d & sp.DIR_CAT_REVERSED) != 0)
        per_tree.append((int(oh.sum()), int((cat & ~oh & ~rev).sum()),
                         int(rev.sum())))
    t = np.array(per_tree or [(0, 0, 0)]).reshape(-1, 3)
    n = len(per_tree)
    names = ("one_hot", "sorted", "reversed")
    return {"trees": n,
            "trees_with_categorical": int((t.sum(axis=1) > 0).sum()),
            "total": dict(zip(names, t.sum(axis=0).tolist())),
            "per_tree": dict(zip(names, (t.sum(axis=0) / max(n, 1))
                                 .tolist()))}


def zipf_choice(rs, k, a, size):
    """``size`` draws of k categories whose frequencies follow a Zipf law of
    exponent ``a`` (category 0 the most frequent)."""
    p = 1.0 / np.arange(1, k + 1) ** a
    return rs.choice(k, size, p=p / p.sum())


def make_categorical_small(n, seed):
    """make_train_small's numeric columns (NaN, zero-heavy, the EFB pair,
    dense) and three categorical ones: 3 categories (6), 40 with NaN and
    negative values (7), 200 drawn from a Zipf law (8); the binary label
    gains their effects."""
    X, _ = make_train_small(n, seed)
    rs = np.random.RandomState(seed + 13)
    c3 = rs.randint(0, 3, n).astype(np.float64)
    c40 = rs.randint(0, 40, n).astype(np.float64)
    c40[rs.rand(n) < 0.05] = np.nan
    neg = rs.rand(n) < 0.03
    c40[neg] = -rs.randint(1, 4, int(neg.sum()))
    c200 = zipf_choice(rs, 200, 1.1, n).astype(np.float64)
    eff40, eff200 = rs.randn(41), rs.randn(200)
    m40 = np.where(np.isnan(c40) | (c40 < 0), 40, c40).astype(int)
    logit = (np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1] + 2.0 * X[:, 2]
             - 1.5 * X[:, 3] + (c3 == 1) + eff40[m40]
             + 0.7 * eff200[c200.astype(int)])
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
    return np.column_stack([X, c3, c40, c200]), y


CAT_SMALL = [6, 7, 8]


def phase_train_categorical_small(seed, n=20_000, iters=5, num_leaves=127):
    """Categorical training on both devices, dyadic custom gradients:
    make_categorical_small's rows under stream (127 leaves at split budget
    64, so the route-only sprint runs), scatter and pallas at max_bin 63
    and 255, GOSS and bagging (unfused: categorical trees never take K3),
    K = 3 in lockstep under stream and pallas, and quantized gradients,
    each byte-identical on the CPU and the card; every K2 (both forms), K4,
    K5, K6, K7 and K8 launch of the card's runs replayed bit-equal through
    its plain version; K1 on a binary model trained on the card, over rows
    with unseen, NaN and negative categories, bit-equal to its plain
    version and within rtol 1e-4 / atol 1e-5 of the host walk."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.basic import _host_predict

    X, y = make_categorical_small(n, seed)
    # at 255 bins the EFB pair would need uint16 bins: one of it is left out
    Xw = np.delete(X, 3, axis=1)
    cat_w = [c - 1 for c in CAT_SMALL]
    rs = np.random.RandomState(seed + 11)
    logits = np.stack([np.nan_to_num(X[:, 0]) + (X[:, 6] == 1),
                       2.0 * X[:, 2] - 1.5 * X[:, 3],
                       np.isin(X[:, 8], [0, 2, 5]) + 0.5 * X[:, 5]], 1)
    y3 = np.argmax(logits + rs.randn(n, 3), axis=1).astype(np.float64)
    base = {"objective": "none", "num_leaves": num_leaves,
            "max_splits_per_round": 64, "max_bin": 63, "verbosity": -1}
    mc = {"objective": "multiclass", "num_class": 3}
    quant = {"use_quantized_grad": True}
    # name: (extra params, data, categorical columns, label, fobj, iters)
    runs = {
        "stream": ({}, X, CAT_SMALL, y, dyadic_fobj, iters),
        "scatter_63": ({"hist_backend": "scatter"}, X, CAT_SMALL, y,
                       dyadic_fobj, 3),
        "pallas_63": ({"hist_backend": "pallas"}, X, CAT_SMALL, y,
                      dyadic_fobj, 3),
        "scatter_255": ({"hist_backend": "scatter", "max_bin": 255}, Xw,
                        cat_w, y, dyadic_fobj, 2),
        "pallas_255": ({"hist_backend": "pallas", "max_bin": 255}, Xw, cat_w,
                       y, dyadic_fobj, 2),
        "goss": (sampled_params("goss"), X, CAT_SMALL, y, dyadic_fobj, iters),
        "bagging": ({"bagging_fraction": 0.7, "bagging_freq": 1}, X,
                    CAT_SMALL, y, dyadic_fobj, iters),
        "multiclass": (mc, X, CAT_SMALL, y3, dyadic_mc_fobj, 3),
        "multiclass_pallas": ({**mc, "hist_backend": "pallas"}, X, CAT_SMALL,
                              y3, dyadic_mc_fobj, 3),
        "quantized": (quant, X, CAT_SMALL, y, pow2_fobj, iters),
    }
    cap, out = Capture(), {}
    for name, (extra, data, cats, label, fobj, n_iter) in runs.items():
        texts = []
        for dev in ("cpu", "cuda"):
            p = {**base, **extra, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(data, label=label,
                                           categorical_feature=cats,
                                           params=p))
            kernels.reset_launch_counts()
            with cap if dev == "cuda" else contextlib.nullcontext():
                for _ in range(n_iter):
                    bst.update(fobj=fobj)
            # the grown trees, before the model text moves them to the host
            kind = cat_kinds([e["arrays"] for e in bst.engine._lazy_trees])
            texts.append(model_trees_text(bst))
        counts = kernels.launch_counts()
        if texts[0] != texts[1]:
            raise RuntimeError(f"categorical {name}: training differs "
                               f"between CPU and card")
        eng = bst.engine
        if not (eng.grow_params.cat is not None
                and kind["trees_with_categorical"] > 0):
            raise RuntimeError(f"categorical {name}: no categorical split "
                               f"({kind})")
        if counts["route_replay"]:
            raise RuntimeError(f"categorical {name}: K3 replayed a "
                               f"categorical tree")
        if name in ("goss", "bagging") and not (
                eng.last_compact_rows > 0
                and eng.route_only_passes_per_tree() > 1):
            raise RuntimeError(f"categorical {name}: compaction "
                               f"{eng.last_compact_rows}, route-only passes "
                               f"{eng.route_only_passes_per_tree()}")
        out[name] = {"leaves_per_tree": [t.num_leaves for t in eng.models],
                     "categorical_splits": kind,
                     "launches": {k: v for k, v in counts.items() if v}}
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    want = ("route_and_hist", "route_and_hist_k", "route_and_hist_int",
            "leaf_gather", "scatter_hist", "hist_direct", "hist_nibble",
            "hist_wide")
    if not all(replayed[k] for k in want):
        raise RuntimeError(f"the categorical runs replayed {replayed}")
    # K1 on a binary model trained on the card, over rows with categories
    # the training rows never had
    p = {**base, "objective": "binary", "device_type": "cuda"}
    grown = KeepGrownTrees()
    bst = lt.train(p, lt.Dataset(X, label=y, categorical_feature=CAT_SMALL,
                                 params=p), iters, callbacks=[grown])
    binary_kind = cat_kinds(grown.arrays)
    Xt = make_categorical_small(n, seed + 1)[0]
    for i, col in enumerate(CAT_SMALL):
        Xt = adversarial_categories(Xt, col, seed + 20 + i)
    _, _, k1_err = check_kernel_against_plain(bst, Xt)
    pred = bst.predict(Xt, raw_score=True)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    host = _host_predict(Xt, use, 1, False, 10, 10.0)
    np.testing.assert_allclose(pred, host, rtol=RTOL, atol=ATOL)
    err["predict_stream"] = k1_err
    fused_cpu = fused_against_cpu(X, y, base, iters,
                                  categorical_feature=CAT_SMALL)
    emit({"phase": "train_categorical_small", "rows": n,
          "fused_card_text_equals_eager_cpu": fused_cpu,
          "num_leaves": num_leaves, "categorical_columns": CAT_SMALL,
          "runs": out, "text_identical_cpu_card": True,
          "replayed_launches": replayed, "replay_max_abs_err": err,
          "binary_categorical_splits": binary_kind,
          "k1_rows": len(Xt), "k1_equals_plain": True,
          "predict_max_abs_err_vs_host": float(np.abs(pred - host).max())})
    return err


# name, categories (None: numeric), of szilard/GBM-perf's airline task
AIRLINE_FEATURES = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                    ("UniqueCarrier", 22), ("Origin", 250), ("Dest", 250),
                    ("DepTime", None), ("Distance", None))
AIRLINE_CATEGORICAL = [i for i, (_, k) in enumerate(AIRLINE_FEATURES) if k]


def make_airline_like(n, seed, positives=0.19, airports=250):
    """Rows in the shape of the airline delay task of szilard/GBM-perf
    (``dep_delayed_15min``: US flights, the label a departure 15 minutes or
    more late): Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and
    Dest as category codes, DepTime as hhmm and Distance in miles.
    Carriers and airports follow Zipf laws, departure times a daytime
    spread, distances a log-normal law.  The label is a logistic of
    per-category effects (fixed by ``seed``), the departure hour and the
    distance, its intercept set for the given share of positives.
    ``airports``: the Origin and Dest categories (the source has ~300)."""
    rs = np.random.RandomState(seed)
    cols, effects = [], 0.0
    eff_rs = np.random.RandomState(seed + 1)
    scale = {"Month": 0.3, "DayofMonth": 0.1, "DayOfWeek": 0.2,
             "UniqueCarrier": 0.4, "Origin": 0.5, "Dest": 0.3}
    for name, k in AIRLINE_FEATURES:
        if k is None:
            continue
        if name in ("Origin", "Dest"):
            k = airports
        codes = (zipf_choice(rs, k, 1.0 if k == 22 else 1.1, n)
                 if name in ("UniqueCarrier", "Origin", "Dest")
                 else rs.randint(0, k, n))
        cols.append(codes)
        effects = effects + scale[name] * eff_rs.randn(k)[codes]
    minutes = np.clip(rs.normal(13.5 * 60, 4.5 * 60, n), 0, 1439).astype(int)
    dep_time = (minutes // 60) * 100 + minutes % 60
    distance = np.clip(np.round(rs.lognormal(6.4, 0.6, n)), 30, 4900)
    hour = minutes / 60.0
    logit = (effects + 0.11 * (hour - 12.0) + 0.0002 * (distance - 700.0)
             + 0.5 * rs.randn(n))
    lo, hi = -10.0, 10.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if (1.0 / (1.0 + np.exp(-(logit + mid)))).mean() > positives:
            hi = mid
        else:
            lo = mid
    p = 1.0 / (1.0 + np.exp(-(logit + 0.5 * (lo + hi))))
    y = (rs.rand(n) < p).astype(np.float64)
    X = np.column_stack(cols + [dep_time, distance]).astype(np.float64)
    return X, y


def phase_train_categorical(seed, smi, rows=1_000_000, held_out=250_000,
                            iters=20, timed_tree=2):
    """The categorical cell at full width: make_airline_like's 1 250 000
    rows, the last 250 000 held out; binary, 255 leaves, max_bin 255,
    learning rate 0.1, the default split budget and categorical
    parameters, backend auto (stream), ``iters`` iterations through
    ``lightgbm_torch.train`` with the kernel counts read around the call
    (K2 and K4 launched, K3 never); ``Booster.predict`` on the held-out
    rows with the counts read around it (K1 launched, the device path
    taken) and AUC > 0.60, beside the AUC of the same rows trained with
    ``categorical_feature=[]`` (a sanity check, not a gate); every K2 and
    K4 launch of one timed tree replayed bit-equal and timed beside its
    bound and an ``index_add_`` call; K1 on the model against its plain
    version and timed; one more iteration timed phase by phase.  Returns
    K2's, K4's and K1's categorical entries and the replays' largest
    differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.basic import _to_2d_float
    from lightgbm_torch.kernels import leaf_gather as lg
    from lightgbm_torch.kernels import predict as tpk

    t0 = time.perf_counter()
    X, y = make_airline_like(rows + held_out, seed)
    Xs, ys = X[rows:], y[rows:]
    X, y = X[:rows], y[:rows]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lt.Dataset(X, label=y, categorical_feature=AIRLINE_CATEGORICAL,
                    params={"max_bin": 255})
    data_s = time.perf_counter() - t0
    construct_s, _, ds_bin_launches, ds_bin_err = construct_replayed(ds, X)
    data_s += construct_s
    mappers = ds.bin_mappers()
    num_bins = [int(m.num_bins) for m in mappers]
    from lightgbm_torch.utils.timer import host_reads

    grown = KeepGrownTrees()
    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters, callbacks=[grown])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    kind = cat_kinds(grown.arrays)
    tree_s, cap = timed.seconds, timed.cap
    if (bst.num_trees() != iters or launches["route_and_hist"] == 0
            or launches["leaf_gather"] != iters or launches["route_replay"]):
        raise RuntimeError(f"categorical training made {bst.num_trees()} "
                           f"trees with launches {launches}")
    if kind["trees_with_categorical"] == 0:
        raise RuntimeError(f"categorical training split no category: {kind}")

    # held-out prediction through K1 (the host side warmed once)
    bst.predict(Xs[:20_000])
    kernels.reset_launch_counts()
    pred, predict_s, _, bin_launches, bin_err = predict_replayed(bst, Xs)
    k1_launches = kernels.launch_counts()["predict_stream"]
    held_auc = auc(ys, pred)
    if not (k1_launches > 0 and pred.shape == (held_out,)
            and np.isfinite(pred).all() and held_auc > 0.60):
        raise RuntimeError(f"categorical predict: {k1_launches} K1 "
                           f"launches, AUC {held_auc}")
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    sentinels = sorted(split_cat_features(use))
    if not sentinels:
        raise RuntimeError("the categorical model splits no categorical "
                           "feature: predict ran no sentinel bins")
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    breakdown = {}
    path = ("device" if bst._device_predict_inputs(
        _to_2d_float(Xs)[0], use, 1, None, times=breakdown) is not None
        else "host")
    inp, (got,), k1_err = check_kernel_against_plain(bst, Xs)
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    k1_ms = device_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv,
                                                      words, maxd), reps=5)
    k1_plain = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    k1_bnd = bound(*k1_work(inp, use, maxd, held_out))

    # the same rows with every column numeric (a sanity check)
    num_ds = lt.Dataset(X, label=y, categorical_feature=[],
                        params={"max_bin": 255})
    t0 = time.perf_counter()
    num_bst = lt.train(params, num_ds, iters)
    torch.cuda.synchronize()
    numeric_train_s = time.perf_counter() - t0
    numeric_auc = auc(ys, num_bst.predict(Xs))

    # K2 and K4 of one tree: replayed, then timed launch by launch
    replayed, err = replay_against_plain(cap)
    full = time_k2_launches([(a, o) for a, o in cap.k2 if a[10]], False)
    route_only = [(a, o) for a, o in cap.k2 if not a[10]]
    route = time_k2_launches(route_only, False) if route_only else None
    (lid, vals), _ = cap.k4[0]
    k4_ms = device_ms(lambda: lg.leaf_gather_cuda(lid, vals))
    k4_plain = device_ms(lambda: lg.leaf_gather_plain(lid, vals))
    k4_lib = device_ms(lambda: torch.index_select(vals, 0, lid))
    k4_bnd = bound(8.0 * lid.numel() + 4.0 * vals.numel(), lid.numel())

    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    profiled_s, phases_s, prof_reads = profiled_iteration(bst)
    total = sum(phases_s.values())
    after_first = tree_s[1:] or tree_s
    emit({"phase": "train_categorical", "card": smi, "rows": rows,
          "held_out_rows": held_out,
          "features": [n for n, _ in AIRLINE_FEATURES],
          "categorical_features": AIRLINE_CATEGORICAL,
          "num_bins": num_bins, "max_bins": int(bst.engine.dd.max_bins),
          "positives": float(y.mean()), "iterations": iters,
          "num_leaves": 255, "data_s": data_s,
          "leaves_per_tree": [t.num_leaves for t in bst.engine.models],
          "categorical_splits": kind,
          "train_s": train_s, "s_per_tree": statistics.median(after_first),
          "first_tree_s": tree_s[0], "tree_s": tree_s,
          "k2_launches_per_tree": launches["route_and_hist"] / iters,
          "replayed_launches_timed_tree": replayed,
          "replay_max_abs_err": err, "k2_full_hist": full,
          "k2_route_only": route,
          "k4_ms": k4_ms, "k4_plain_ms": k4_plain, "k4_library_ms": k4_lib,
          "k4_bound_ms": k4_bnd[0],
          "held_out_auc": held_auc, "numeric_only_auc": numeric_auc,
          "numeric_only_train_s": numeric_train_s,
          "predict_s": predict_s, "predict_path": path,
          "predict_breakdown_s": breakdown,
          "bin_rows": {"construct_s": construct_s,
                       "dataset_launches_replayed": ds_bin_launches,
                       "predict_launches_replayed": bin_launches,
                       "sentinel_features": sentinels,
                       "max_abs_err": max(bin_err, ds_bin_err)},
          "k1_launches": k1_launches,
          "k1_ms": k1_ms, "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bnd[0],
          "k1_bound_by": k1_bnd[1], "k1_equals_plain": True,
          "profiled_iteration_s": profiled_s,
          "profiled_iteration_phases_s": phases_s,
          "profiled_iteration_phase_share": {
              k: v / total for k, v in phases_s.items()} if total else {},
          "profiled_iteration_host_reads": prof_reads,
          "fused_iter": fused})
    k2 = {"cell": "train_categorical", "max_bins": int(bst.engine.dd.max_bins),
          "launches": launches["route_and_hist"],
          "ms": full["mean_ms"], "plain_ms": full["mean_plain_ms"],
          "bound_ms": full["mean_bound_ms"], "bound_by": full["bound_by"],
          "library_ms": full["mean_index_add_ms"]}
    k4 = {"cell": "train_categorical", "launches": launches["leaf_gather"],
          "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bnd[0],
          "library_ms": k4_lib}
    k1 = {"cell": "train_categorical", "launches": k1_launches,
          "rows": held_out, "trees": len(use), "ms": k1_ms,
          "plain_ms": k1_plain, "bound_ms": k1_bnd[0], "bound_by": k1_bnd[1]}
    err["predict_stream"] = k1_err
    err["bin_rows"] = max(bin_err, ds_bin_err)
    return {"route_and_hist": k2, "leaf_gather": k4,
            "predict_stream": k1}, err


# --------------------------------------------------------------------------
# groups wider than 256 bins (16-bit bins)
# --------------------------------------------------------------------------

def make_wide_small(n, seed):
    """Rows whose EFB bundle is wider than 256 bins at the default max_bin
    255: two dense columns and six mutually exclusive sparse ones (each
    row holds at most one, 3 in 4 rows one of them), continuous values,
    so that the six bundle into one group of ~1500 bins (3 groups in all);
    a binary label from both kinds."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, 8))
    X[:, 0] = rs.randn(n)
    X[:, 1] = rs.randn(n)
    which = rs.randint(0, 8, n)
    for j in range(6):
        m = which == j
        X[m, 2 + j] = rs.rand(int(m.sum())) + 0.5
    logit = (X[:, 0] + 0.5 * X[:, 1] + 2.0 * (X[:, 3] > 1.0)
             - 1.5 * (X[:, 5] > 0.8))
    y = (logit + 0.5 * rs.randn(n) > 0).astype(np.float64)
    return X, y


def wide_label3(X, seed):
    """A 3-class label on make_wide_small's rows."""
    rs = np.random.RandomState(seed)
    logits = np.stack([X[:, 0], 2.0 * (X[:, 3] > 1.0) + X[:, 1],
                       1.5 * (X[:, 5] > 0.8) - X[:, 0]], axis=1)
    return np.argmax(logits + rs.randn(len(X), 3), axis=1).astype(float)


def wide_group_bins(bst):
    """(group count, each group's bin count, Bmax) of a trained booster's
    data."""
    eng = bst.engine
    binned = eng.train_data.binned
    counts = [int(c) for c in binned.group_bin_counts]
    return len(binned.group_features), counts, int(eng.dd.max_bins)


def phase_train_wide_small(seed, n=20_000, iters=3, num_leaves=31):
    """Training on 16-bit bins on both devices: make_wide_small's rows at
    the defaults (3 groups, one of ~1500 bins), dyadic custom gradients
    (quantized: power-of-two scales) under stream, scatter, pallas, GOSS
    (127 leaves at budget 64: fused, K3), bagging, quantized gradients and
    K = 3 in lockstep under stream and scatter, each byte-identical on the
    CPU and the card, the card's runs through the 16-bit forms, pallas's
    card text equal to scatter's; every K2 (three forms), K3, K4, K5, K7
    and K8 launch of the card's runs replayed bit-equal through its plain
    version; K1 over 16-bit bins on a binary model trained on the card,
    bit-equal to its plain version and within rtol 1e-4 / atol 1e-5 of the
    host walk."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.basic import _host_predict

    X, y = make_wide_small(n, seed)
    y3 = wide_label3(X, seed + 1)
    base = {"objective": "none", "num_leaves": num_leaves,
            "max_splits_per_round": 8, "min_data_in_leaf": 5,
            "verbosity": -1}
    mc = {"objective": "multiclass", "num_class": 3}
    goss = {**sampled_params("goss"), "num_leaves": 127,
            "max_splits_per_round": 64}
    # name: (extra params, label, fobj, iterations, kernel whose 16-bit
    # form the card's run must launch)
    runs = {
        "stream": ({}, y, dyadic_fobj, iters, "route_and_hist"),
        "scatter": ({"hist_backend": "scatter"}, y, dyadic_fobj, iters,
                    "scatter_hist"),
        "pallas": ({"hist_backend": "pallas"}, y, dyadic_fobj, iters,
                   "hist_nibble"),
        "goss": (goss, y, dyadic_fobj, 4, "route_replay"),
        "bagging": ({"bagging_fraction": 0.5, "bagging_freq": 1}, y,
                    dyadic_fobj, iters, "route_and_hist"),
        "quantized": ({"use_quantized_grad": True}, y, pow2_fobj, iters,
                      "route_and_hist_int"),
        "multiclass": (mc, y3, dyadic_mc_fobj, 2, "route_and_hist"),
        "multiclass_scatter": ({**mc, "hist_backend": "scatter"}, y3,
                               dyadic_mc_fobj, 2, "hist_wide"),
    }
    cap, out, groups, card_text = Capture(), {}, None, {}
    for name, (extra, label, fobj, n_iter, want) in runs.items():
        texts = []
        for dev in ("cpu", "cuda"):
            p = {**base, **extra, "device_type": dev}
            bst = lt.Booster(p, lt.Dataset(X, label=label, params=p))
            kernels.reset_launch_counts()
            with cap if dev == "cuda" else contextlib.nullcontext():
                for _ in range(n_iter):
                    bst.update(fobj=fobj)
            texts.append(model_trees_text(bst))
        wide = kernels.wide_launch_counts()
        if texts[0] != texts[1]:
            raise RuntimeError(f"wide {name}: training differs between CPU "
                               f"and card")
        groups = wide_group_bins(bst)
        if not (bst.engine.dd.bins.dtype == torch.int16 and wide[want] > 0
                and groups[2] > 256):
            raise RuntimeError(f"wide {name}: bins {bst.engine.dd.bins.dtype}"
                               f", groups {groups}, 16-bit launches {wide}")
        out[name] = {"leaves_per_tree": [t.num_leaves
                                         for t in bst.engine.models],
                     "wide_launches": {k: v for k, v in wide.items() if v}}
        card_text[name] = texts[1]
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    need = ("route_and_hist", "route_and_hist_k", "route_and_hist_int",
            "route_replay", "leaf_gather", "scatter_hist", "hist_nibble",
            "hist_wide")
    if not all(replayed[k] for k in need):
        raise RuntimeError(f"the wide runs replayed {replayed}")
    if card_text["pallas"] != card_text["scatter"]:
        raise RuntimeError("wide pallas and scatter grow different trees")
    # K1 over 16-bit bins, on a binary model trained on the card
    p = {**base, "objective": "binary", "device_type": "cuda"}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 5)
    Xt = make_wide_small(n, seed + 1)[0]
    kernels.reset_launch_counts()
    pred = bst.predict(Xt, raw_score=True)
    k1_wide = kernels.wide_launch_counts()["predict_stream"]
    inp, _, k1_err = check_kernel_against_plain(bst, Xt)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    host = _host_predict(Xt, use, 1, False, 10, 10.0)
    np.testing.assert_allclose(pred, host, rtol=RTOL, atol=ATOL)
    if not (k1_wide == 1 and inp.bins_T.dtype == torch.int16):
        raise RuntimeError(f"wide predict: {k1_wide} 16-bit K1 launches")
    err["predict_stream"] = k1_err
    fused_cpu = fused_against_cpu(X, y, base, iters)
    emit({"phase": "train_wide_small", "rows": n, "groups": groups[0],
          "fused_card_text_equals_eager_cpu": fused_cpu,
          "group_bins": groups[1], "max_bins": groups[2], "runs": out,
          "text_identical_cpu_card": True, "replayed_launches": replayed,
          "replay_max_abs_err": err,
          "k1_rows": len(Xt), "k1_equals_plain": True,
          "predict_max_abs_err_vs_host": float(np.abs(pred - host).max())})
    return err


WIDE_ONEHOT = ("Month", "DayofMonth", "DayOfWeek", "UniqueCarrier",
               "Origin", "Dest")


def make_airline_onehot(n, seed, airports=300):
    """make_airline_like's rows with its six categorical fields one-hot
    encoded into 0/1 float columns (the LightGBM paper's Flight Delay set,
    the airline data so encoded), DepTime and Distance as they are: at 300
    airports 12 + 31 + 7 + 22 + 300 + 300 = 672 one-hot columns and two
    numeric ones, 674 in all."""
    X, y = make_airline_like(n, seed, airports=airports)
    sizes = [k if name not in ("Origin", "Dest") else airports
             for name, k in AIRLINE_FEATURES if k]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros((n, int(offsets[-1]) + 2))
    rows = np.arange(n)
    for j, off in enumerate(offsets[:-1]):
        out[rows, int(off) + X[:, j].astype(np.int64)] = 1.0
    out[:, -2:] = X[:, -2:]
    return out, y


def phase_train_wide(seed, smi, rows=500_000, held_out=100_000, iters=20,
                     goss_iters=15, backend_iters=10, timed_tree=2):
    """The Flight Delay cell: make_airline_onehot's 674 columns at 300
    airports, ``rows`` trained and ``held_out`` held out; binary, 255
    leaves, max_bin 255, default EFB (bundles of one-hot columns past 256
    bins: 16-bit bins), learning rate 0.1, ``iters`` iterations under auto
    (stream, K2), the kernel counts read around each call; a GOSS arm at
    LightGBM's default rates (``goss_iters``, 10 of warmup: K3), a scatter
    arm (K5), a quantized arm (K2's int form) and a 3-class scatter arm on
    200 000 of the rows (K8); held-out ``Booster.predict`` through K1 (AUC
    > 0.60); one tree's launches of each arm replayed bit-equal, then timed
    beside the bound and, where one exists, an ``index_add_`` call; one
    more iteration timed phase by phase; the Dataset binned on the card,
    one chunk of its rows timed through bin_rows' training form.  Returns
    the 16-bit entries of K1, K2, K2 int, K3, K5, K7, K8 and bin_rows and
    the replays' largest differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.kernels import predict as tpk
    from lightgbm_torch.kernels import route_replay as rr

    t0 = time.perf_counter()
    X, y = make_airline_onehot(rows + held_out, seed)
    Xs, ys = X[rows:], y[rows:]
    X, y = X[:rows], y[:rows]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lt.Dataset(X, label=y, params={"max_bin": 255})
    data_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    construct_s, ds_cap, ds_bin_launches, ds_bin_err = construct_replayed(
        ds, X)
    data_s += construct_s
    ds_bin_wide = kernels.wide_launch_counts()["bin_rows"]
    if ds_bin_wide != ds_bin_launches:
        raise RuntimeError(f"Flight Delay Dataset: {ds_bin_wide} of "
                           f"{ds_bin_launches} bin_rows launches 16-bit")
    # the training form over 16-bit bins: one (N, G) chunk of the Dataset
    bin_time = time_bin_rows(ds_cap)
    del ds_cap

    from lightgbm_torch.utils.timer import host_reads

    def run(extra, n_iter, data=ds, capture_at=timed_tree):
        kernels.reset_launch_counts()
        with TimedIters(capture_at=capture_at) as timed:
            t0 = time.perf_counter()
            bst = lt.train({**params, **extra}, data, n_iter)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        return (bst, timed, train_s, kernels.launch_counts(),
                kernels.wide_launch_counts())

    r0 = host_reads()
    bst, timed, train_s, launches, wide = run({}, iters)
    reads = host_reads() - r0
    n_groups, group_bins, Bmax = wide_group_bins(bst)
    if bst.engine.dd.bins.dtype != torch.int16 or Bmax <= 256:
        raise RuntimeError(f"Flight Delay rows: no group past 256 bins "
                           f"({group_bins})")
    if (bst.num_trees() != iters or wide["route_and_hist"] == 0
            or launches["leaf_gather"] != iters):
        raise RuntimeError(f"wide training made {bst.num_trees()} trees "
                           f"with launches {launches}, 16-bit {wide}")
    # held-out prediction through K1 (the host side warmed once)
    bst.predict(Xs[:20_000])
    kernels.reset_launch_counts()
    pred, predict_s, _, bin_launches, bin_err = predict_replayed(bst, Xs)
    k1_launches = kernels.wide_launch_counts()["predict_stream"]
    bin_wide = kernels.wide_launch_counts()["bin_rows"]
    held_auc = auc(ys, pred)
    if bin_wide == 0:
        raise RuntimeError("wide predict binned no 16-bit rows")
    if not (k1_launches == 1 and pred.shape == (held_out,)
            and np.isfinite(pred).all() and held_auc > 0.60):
        raise RuntimeError(f"wide predict: {k1_launches} 16-bit K1 "
                           f"launches, AUC {held_auc}")
    inp, _, k1_err = check_kernel_against_plain(bst, Xs)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    k1_ms = device_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv,
                                                      words, maxd), reps=5)
    k1_plain = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    k1_bnd = bound(*k1_work(inp, use, maxd, held_out))
    replayed, err = replay_against_plain(timed.cap)
    k2 = time_k2_launches([(a, o) for a, o in timed.cap.k2 if a[10]], False)
    # the fused iteration (the main path) against the eager one
    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    profiled_s, phases_s, prof_reads = profiled_iteration(bst)
    total = sum(phases_s.values())
    tree_s = timed.seconds

    # GOSS at the default rates: K3 over the 16-bit bins
    goss = {"data_sample_strategy": "goss"}
    g_bst, g_timed, g_train_s, g_launches, g_wide = run(goss, goss_iters,
                                                        capture_at=12)
    if g_wide["route_replay"] == 0 or len(g_timed.cap.k3) != 1:
        raise RuntimeError(f"wide GOSS: 16-bit launches {g_wide}, "
                           f"{len(g_timed.cap.k3)} K3 in the timed tree")
    g_rep, g_err = replay_against_plain(g_timed.cap)
    (k3_bins, k3_tabs), _ = g_timed.cap.k3[0]
    k3_ms = device_ms(lambda: rr.route_replay_cuda(k3_bins, k3_tabs))
    k3_plain = cuda_ms(lambda: rr.route_replay_plain(k3_bins, k3_tabs),
                       reps=1, warmup=0)
    k3_bnd = bound(*k3_work(k3_bins, k3_tabs))
    k3_special = int((rr.pack_records(k3_tabs, k3_bins.shape[0], True)
                      [..., 1] < 0).sum().item())

    # scatter: K5 over the 16-bit bins
    s_bst, s_timed, s_train_s, _, s_wide = run({"hist_backend": "scatter"},
                                               backend_iters)
    if s_wide["scatter_hist"] == 0:
        raise RuntimeError(f"wide scatter: 16-bit launches {s_wide}")
    s_rep, s_err = replay_against_plain(s_timed.cap)
    k5 = time_hist_launches("scatter_hist", s_timed.cap.k5)
    s_auc = auc(ys, s_bst.predict(Xs))

    # pallas: K7's 16-bit form over the slot-sorted block plan
    p_bst, p_timed, p_train_s, p_launches, p_wide = run(
        {"hist_backend": "pallas"}, backend_iters)
    if p_wide["hist_nibble"] == 0 or p_launches["route_and_hist"]:
        raise RuntimeError(f"wide pallas: launches {p_launches}, 16-bit "
                           f"{p_wide}")
    if model_trees_text(p_bst) != model_trees_text(s_bst):
        raise RuntimeError("wide pallas and scatter grow different trees")
    p_rep, p_err = replay_against_plain(p_timed.cap)
    k7 = time_hist_launches("hist_nibble", p_timed.cap.k67)
    p_auc = auc(ys, p_bst.predict(Xs))

    # quantized gradients: K2's int form over the 16-bit bins
    q_bst, q_timed, q_train_s, _, q_wide = run({"use_quantized_grad": True},
                                               5)
    if q_wide["route_and_hist_int"] == 0:
        raise RuntimeError(f"wide quantized: 16-bit launches {q_wide}")
    q_rep, q_err = replay_against_plain(q_timed.cap)
    k2i = time_k2_launches([(a, o) for a, o in q_timed.cap.k2i if a[9]],
                           True)

    # K = 3 under scatter: K8 over the same mappers' 16-bit bins
    mc_rows = min(rows, 200_000)
    dep_hour = X[:mc_rows, -2] // 100
    y3 = np.where(y[:mc_rows] > 0, 2, (dep_hour >= 17).astype(int))
    mc_ds = lt.Dataset(X[:mc_rows], label=y3.astype(float), reference=ds)
    m_bst, m_timed, m_train_s, _, m_wide = run(
        {"objective": "multiclass", "num_class": 3,
         "hist_backend": "scatter"}, 3, data=mc_ds, capture_at=1)
    if m_wide["hist_wide"] == 0:
        raise RuntimeError(f"wide multiclass: 16-bit launches {m_wide}")
    m_rep, m_err = replay_against_plain(m_timed.cap)
    k8 = time_hist_launches("hist_wide", m_timed.cap.k8)

    for e in (g_err, s_err, p_err, q_err, m_err):
        for k, v in e.items():
            err[k] = max(err.get(k, 0.0), v)
    err["predict_stream"] = k1_err
    err["bin_rows"] = max(bin_err, ds_bin_err)
    after_first = tree_s[1:] or tree_s
    emit({"phase": "train_wide", "card": smi, "rows": rows,
          "held_out_rows": held_out, "features": int(X.shape[1]),
          "one_hot_fields": list(WIDE_ONEHOT), "airports": 300,
          "data_s": data_s, "groups": n_groups, "group_bins": group_bins,
          "groups_past_256_bins": sum(b > 256 for b in group_bins),
          "max_bins": Bmax, "iterations": iters, "num_leaves": 255,
          "leaves_per_tree": [t.num_leaves for t in bst.engine.models],
          "train_s": train_s, "s_per_tree": statistics.median(after_first),
          "first_tree_s": tree_s[0], "tree_s": tree_s,
          "k2_launches_per_tree": launches["route_and_hist"] / iters,
          "launches": launches, "wide_launches": wide,
          "held_out_auc": held_auc, "predict_s": predict_s,
          "bin_rows": {"construct_s": construct_s,
                       "dataset_launches_replayed": ds_bin_launches,
                       "predict_launches_replayed": bin_launches,
                       "predict_wide_launches": bin_wide,
                       "timed_launch": bin_time,
                       "max_abs_err": max(bin_err, ds_bin_err)},
          "k1_launches": k1_launches, "k1_ms": k1_ms,
          "k1_plain_ms": k1_plain, "k1_bound_ms": k1_bnd[0],
          "k1_bound_by": k1_bnd[1], "k1_equals_plain": True,
          "replayed_launches_timed_tree": replayed, "k2_full_hist": k2,
          "profiled_iteration_s": profiled_s,
          "profiled_iteration_phases_s": phases_s,
          "profiled_iteration_phase_share": {
              k: v / total for k, v in phases_s.items()} if total else {},
          "profiled_iteration_host_reads": prof_reads,
          "fused_iter": fused,
          "goss": {"iterations": goss_iters, "train_s": g_train_s,
                   "s_per_tree_sampled": statistics.median(
                       g_timed.seconds[10:] or g_timed.seconds),
                   "wide_launches": g_wide, "replayed": g_rep,
                   "k3_ms": k3_ms, "k3_plain_ms": k3_plain,
                   "k3_bound_ms": k3_bnd[0], "k3_rounds": int(
                       k3_tabs.shape[0]), "k3_special_records": k3_special},
          "scatter": {"iterations": backend_iters, "train_s": s_train_s,
                      "s_per_tree": statistics.median(s_timed.seconds[1:]),
                      "held_out_auc": s_auc, "wide_launches": s_wide,
                      "replayed": s_rep, "k5": k5},
          "pallas": {"iterations": backend_iters, "train_s": p_train_s,
                     "s_per_tree": statistics.median(p_timed.seconds[1:]),
                     "held_out_auc": p_auc, "text_equals_scatter": True,
                     "wide_launches": p_wide, "replayed": p_rep, "k7": k7},
          "quantized": {"iterations": 5, "train_s": q_train_s,
                        "wide_launches": q_wide, "replayed": q_rep,
                        "k2_int_full_hist": k2i},
          "multiclass_scatter": {"rows": mc_rows, "iterations": 3,
                                 "train_s": m_train_s,
                                 "wide_launches": m_wide,
                                 "replayed": m_rep, "k8": k8},
          "replay_max_abs_err": err})

    def entry(launches_n, name, ms, plain, bnd, lib):
        return {"cell": "train_wide", "max_bins": Bmax,
                "launches": launches_n, "max_abs_err": err.get(name, 0.0),
                "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib}

    def hist_entry(launches_n, name, t):
        return entry(launches_n, name, t["mean_ms"], t["mean_plain_ms"],
                     (t["mean_bound_ms"], t["bound_by"]),
                     t["mean_index_add_ms"])

    return {"predict_stream": {**entry(k1_launches, "predict_stream", k1_ms,
                                       k1_plain, k1_bnd, None),
                               "rows": held_out, "trees": len(use)},
            "route_and_hist": hist_entry(wide["route_and_hist"],
                                         "route_and_hist", k2),
            "route_and_hist_int": hist_entry(q_wide["route_and_hist_int"],
                                             "route_and_hist_int", k2i),
            "route_replay": entry(g_wide["route_replay"], "route_replay",
                                  k3_ms, k3_plain, k3_bnd, None),
            "scatter_hist": hist_entry(s_wide["scatter_hist"],
                                       "scatter_hist", k5),
            "hist_nibble": hist_entry(p_wide["hist_nibble"], "hist_nibble",
                                      k7),
            "hist_wide": hist_entry(m_wide["hist_wide"], "hist_wide", k8),
            "bin_rows": {**entry(ds_bin_wide + bin_wide, "bin_rows",
                                 bin_time["ms"], bin_time["plain_ms"],
                                 (bin_time["bound_ms"],
                                  bin_time["bound_by"]), None),
                         "rows": bin_time["rows"],
                         "transpose": bin_time["transpose"],
                         "plan": bin_time["plan"]}}, err


# --------------------------------------------------------------------------
# learning to rank
# --------------------------------------------------------------------------

def make_mslr_like(n_docs, f, docs_per_q=120, seed=11):
    """bench.py's MSLR-WEB30K-shaped ranking task, copied (the script
    imports nothing of the JAX package's benchmark): ~120 documents a query,
    grades 0-4 by a query's top fractions, and MSLR's feature structure (5
    text streams x 25 retrieval statistics plus 11 web and click features:
    small integer counts, empty anchor and url streams, zero-inflated
    heavy-tailed clicks)."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n_docs, f), np.float32)
    qlen = rs.randint(1, 6, n_docs).astype(np.float32)
    presence = {
        "body": np.ones(n_docs, bool),
        "anchor": rs.rand(n_docs) < 0.35,
        "title": rs.rand(n_docs) < 0.95,
        "url": rs.rand(n_docs) < 0.60,
        "whole": np.ones(n_docs, bool),
    }
    lengths = {
        "body": np.maximum(rs.lognormal(6.0, 0.8, n_docs), 30),
        "anchor": rs.poisson(6, n_docs) + 1.0,
        "title": rs.randint(3, 13, n_docs).astype(np.float64),
        "url": rs.randint(5, 21, n_docs).astype(np.float64),
        "whole": np.maximum(rs.lognormal(6.1, 0.8, n_docs), 35),
    }
    quality = rs.randn(n_docs)
    col = 0
    bm25 = {}
    for s in ("body", "anchor", "title", "url", "whole"):
        p = presence[s]
        ln = lengths[s]
        cov = np.minimum(rs.binomial(5, 0.55, n_docs), qlen)
        tf_sum = rs.poisson(np.where(p, 2 + 0.02 * np.minimum(ln, 200), 0))
        idf = np.round(rs.gamma(4.0, 1.5, n_docs), 2)
        bm = np.maximum(
            2.0 * quality + 0.4 * cov + rs.randn(n_docs), 0) * p
        bm25[s] = bm
        tf_max = np.minimum(tf_sum, rs.poisson(2, n_docs) + 1)
        lmir = np.round(-rs.gamma(3.0, 1.0, n_docs), 3) * p
        feats = [
            cov * p,
            np.round(cov / qlen, 2) * p,
            np.round(ln) * p,
            np.round(idf, 1) * p,
            tf_sum * p,
            tf_max * p,
            np.round(tf_sum / np.maximum(ln, 1), 4) * p,
            np.round(bm, 3),
            lmir,
            np.round(lmir * rs.uniform(0.8, 1.2, n_docs), 3),
        ]
        take = min(len(feats), f - col)
        for v in feats[:take]:
            X[:, col] = v.astype(np.float32)
            col += 1
    streams = list(presence)
    while col < f - 11:
        s = streams[col % 5]
        X[:, col] = (np.maximum(
            quality * rs.uniform(0.5, 1.5) + rs.randn(n_docs), 0)
            * presence[s]).astype(np.float32)
        col += 1
    web = [
        np.round(rs.pareto(2.5, n_docs) * 40),
        np.round(rs.pareto(2.5, n_docs) * 15),
        rs.randint(30, 130, n_docs).astype(np.float64),
        rs.randint(1, 9, n_docs).astype(np.float64),
        np.minimum(rs.poisson(0.8, n_docs), 255),
        np.where(rs.rand(n_docs) < 0.85, 0, rs.poisson(3, n_docs)),
        np.where(rs.rand(n_docs) < 0.8, 0,
                 np.round(rs.gamma(2, 20, n_docs))),
        np.round(np.maximum(quality + rs.randn(n_docs) * 0.7, 0) * 30),
        rs.randint(0, 256, n_docs).astype(np.float64),
        rs.randint(0, 256, n_docs).astype(np.float64),
        np.round(rs.pareto(3.0, n_docs) * 10),
    ]
    for v in web[:f - col]:
        X[:, col] = v.astype(np.float32)
        col += 1
    pagerank = web[7]
    clicks = web[5]
    rel = (0.9 * bm25["body"] + 0.5 * bm25["title"] + 0.3 * bm25["anchor"]
           + 0.015 * pagerank + 0.25 * np.minimum(clicks, 4)
           + 1.8 * rs.randn(n_docs))
    nq = max(1, n_docs // docs_per_q)
    sizes = np.full(nq, docs_per_q, np.int64)
    sizes[-1] += n_docs - sizes.sum()
    y = np.zeros(n_docs)
    start = 0
    for s in sizes:
        seg = rel[start:start + s]
        ranks = np.argsort(np.argsort(seg))
        frac = ranks / max(s - 1, 1)
        y[start:start + s] = np.select(
            [frac >= 0.98, frac >= 0.92, frac >= 0.80, frac >= 0.55],
            [4, 3, 2, 1], default=0)
        start += s
    return X, y, sizes


def ndcg_at_k(y, score, sizes, k=10):
    """bench.py's NDCG@k (gains 2^y - 1, ties in score order by argsort),
    averaged over the queries that have a positive gain: the north star's
    quality gate."""
    out = []
    start = 0
    gains = 2.0 ** y - 1.0
    for s in sizes:
        seg_g = gains[start:start + s]
        seg_s = score[start:start + s]
        if seg_g.max() > 0:
            order = np.argsort(-seg_s)[:k]
            disc = 1.0 / np.log2(np.arange(2, 2 + len(order)))
            dcg = float(np.sum(seg_g[order] * disc))
            ideal = np.sort(seg_g)[::-1][:k]
            idcg = float(np.sum(ideal * disc[:len(ideal)]))
            out.append(dcg / idcg)
        start += s
    return float(np.mean(out))


def make_ranking_small(n, seed):
    """About ``n`` documents in ragged queries of 1 to ~400 (buckets of 8
    up to 512 slots; the generic gather path), 8 numeric features (NaN in
    one), grades 0-4 by a query's top fractions, and each document's
    display position: its rank within the query under a noisy copy of the
    relevance."""
    rs = np.random.RandomState(seed + 31)
    sizes = []
    while sum(sizes) < n:
        u = rs.rand()
        sizes.append(int(rs.randint(1, 30) if u < 0.6 else
                         rs.randint(30, 150) if u < 0.9 else
                         rs.randint(150, 400)))
    sizes = np.asarray(sizes + [1, 1], np.int64)
    m = int(sizes.sum())
    X = rs.randn(m, 8)
    X[rs.rand(m) < 0.1, 3] = np.nan
    rel = X[:, 0] * 1.5 + X[:, 1] - 0.5 * X[:, 2] ** 2 + 0.8 * rs.randn(m)
    noisy = rel + rs.randn(m)
    y = np.zeros(m)
    pos = np.zeros(m, np.int64)
    start = 0
    for s in sizes:
        seg = slice(start, start + s)
        frac = np.argsort(np.argsort(rel[seg])) / max(s - 1, 1)
        y[seg] = np.select([frac >= 0.95, frac >= 0.85, frac >= 0.7,
                            frac >= 0.45], [4, 3, 2, 1], default=0)
        pos[seg] = np.argsort(np.argsort(-noisy[seg]))
        start += s
    # one query whose documents all have one grade
    y[:sizes[0]] = 2
    return X, y, sizes, np.minimum(pos, 40)


RANK_SMALL_ARMS = {
    "lambdarank": {},
    "quantized": {"use_quantized_grad": True, "num_grad_quant_bins": 64},
    "bagging_by_query": {"bagging_by_query": True, "bagging_fraction": 0.5,
                         "bagging_freq": 1},
    "position_bias": {"position": True,
                      "lambdarank_position_bias_regularization": 0.1},
    "rank_xendcg": {"objective": "rank_xendcg"},
}


# position-debiased lambdarank after its first step: two devices' biases
# differ in their last bits, which shift every score, and lambdarank_norm's
# 1 / (0.01 + |s_i - s_j|) weighs a near-tied pair's shift by up to 100
# (measured: 1.0e-5 of the scale, the JAX package against the port on the
# CPU, 20 000 documents)
POS_BIAS_STEP_RTOL = 2.5e-5


def ranking_gradients_card_vs_cpu(y, sizes, pos, seed):
    """Lambdarank, lambdarank without norm at truncation 1, and XE-NDCG
    gradients on the card against the port's on the CPU, on the same
    scores (ties included), and position-debiased lambdarank over three
    steps on scores without ties (an ulp in a bias reorders two tied
    documents): within the CPU tests' rule, |card - cpu| <= 4e-6 * max(1,
    max |cpu|) (the devices' float32 sigmoid and exp round apart),
    position bias after its first step within ``POS_BIAS_STEP_RTOL`` of
    the scale, the biases within atol 1e-6.  Returns each objective's (and
    step's) difference over that scale, and the biases' absolute one."""
    import torch
    from lightgbm_torch import device_data, ranking
    from lightgbm_torch.config import Config

    card = device_data.resolve_device("cuda")
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = len(y)
    rs = np.random.RandomState(seed + 7)
    untied = (rs.randn(n) * 2).astype(np.float32)
    score = np.round(untied, 1)
    out = {}
    for name, cls, params, kw, steps in (
            ("lambdarank", ranking.LambdarankNDCG, {}, {}, 1),
            ("lambdarank_no_norm_trunc_1", ranking.LambdarankNDCG,
             {"lambdarank_norm": False, "lambdarank_truncation_level": 1},
             {}, 1),
            ("position_bias", ranking.LambdarankNDCG, {},
             {"position": pos}, 3),
            ("rank_xendcg", ranking.RankXENDCG, {"objective_seed": 3}, {},
             2)):
        objs = {}
        for dev in ("cpu", "cuda"):
            o = cls(Config.from_params({"objective": "lambdarank",
                                        **params}))
            o.init(y, None, query_boundaries=qb, n=n, **kw)
            objs[dev] = o
        s = untied if kw else score
        for step in range(steps):
            gc, hc = objs["cpu"].get_gradients(torch.as_tensor(s))
            gd, hd = objs["cuda"].get_gradients(
                torch.as_tensor(s, device=card))
            rel = max(max_abs_diff(a, b) / max(1.0, float(b.abs().max()))
                      for a, b in ((gd.cpu(), gc), (hd.cpu(), hc)))
            # after a bias step the biases' last bits shift every score
            limit = 4e-6 if step == 0 else POS_BIAS_STEP_RTOL
            if not rel <= limit:
                raise RuntimeError(f"{name} gradients of step {step} on the "
                                   f"card differ from the CPU's by {rel} "
                                   f"of their scale")
            out[name if step == 0 else f"{name}_step_{step}"] = rel
        if kw:
            # the tests' atol on the biases after three steps
            bias = max_abs_diff(objs["cuda"].pos_biases.cpu(),
                                objs["cpu"].pos_biases)
            if not bias <= 1e-6:
                raise RuntimeError(f"position biases on the card differ "
                                   f"from the CPU's by {bias}")
            out["position_biases_abs"] = bias
    return out


def phase_train_ranking_small(seed, n=20_000, iters=5, num_leaves=127):
    """Learning to rank on both devices: ragged queries of 1 to ~400
    documents (``make_ranking_small``), 127 leaves at a split budget of 64
    (the route-only sprint round), ``iters`` iterations, arms lambdarank
    (float), quantized (64 levels), ``bagging_by_query`` (half the queries,
    a fresh draw every iteration: compacted, K3), position-debiased
    lambdarank and rank_xendcg.  The card's gradients must match the CPU's
    (``ranking_gradients_card_vs_cpu``); each arm's first tree must be the
    same on both devices; each arm that fuses must give byte-identical text
    fused and eager on the card; every K2 (both forms), K3 and K4 launch of
    the card's fused runs is replayed bit-equal through its plain
    version."""
    import torch
    import lightgbm_torch as lt

    X, y, sizes, pos = make_ranking_small(n, seed)
    grad_err = ranking_gradients_card_vs_cpu(y, sizes, pos, seed)
    base = {"objective": "lambdarank", "num_leaves": num_leaves,
            "max_splits_per_round": 64, "max_bin": 63,
            "min_data_in_leaf": 5, "verbosity": -1}
    cap = Capture()
    arms = {}
    for name, extra in RANK_SMALL_ARMS.items():
        extra = dict(extra)
        position = pos if extra.pop("position", False) else None
        runs = {}
        for dev, fused in (("cpu", "auto"), ("cuda", "auto"),
                           ("cuda", "off")):
            p = {**base, **extra, "device_type": dev, "fused_iter": fused}
            ds = lt.Dataset(X, label=y, group=sizes, position=position,
                            params=p)
            with (cap if (dev, fused) == ("cuda", "auto")
                  else contextlib.nullcontext()):
                runs[dev, fused] = lt.train(p, ds, iters)
        cpu, card, eager = (runs[k] for k in (("cpu", "auto"),
                                              ("cuda", "auto"),
                                              ("cuda", "off")))
        fuses = name != "rank_xendcg"
        if card.engine._fused != fuses or eager.engine._fused:
            raise RuntimeError(f"ranking {name}: fused {card.engine._fused}")
        c_trees, g_trees = cpu.engine.models, card.engine.models
        if len(g_trees) != iters or \
                tree_structure(c_trees[0]) != tree_structure(g_trees[0]):
            raise RuntimeError(f"ranking {name}: the first tree differs "
                               "between devices")
        if fuses and model_trees_text(card) != model_trees_text(eager):
            raise RuntimeError(f"ranking {name}: fused and eager text "
                               "differ on the card")
        arms[name] = {
            "fused": card.engine._fused,
            "fused_text_equals_eager": True if fuses else None,
            "trees_differing_cpu_card": sum(
                tree_structure(a) != tree_structure(b)
                for a, b in zip(c_trees, g_trees)),
            "leaves_per_tree": [t.num_leaves for t in g_trees],
            "compact_rows": card.engine.last_compact_rows}
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not (replayed["route_and_hist"] and replayed["route_and_hist_int"]
            and replayed["route_replay"] and replayed["leaf_gather"]):
        raise RuntimeError(f"ranking small: replayed {replayed}")
    emit({"phase": "train_ranking_small", "docs": int(len(y)),
          "queries": int(len(sizes)), "max_query": int(sizes.max()),
          "iterations": iters, "num_leaves": num_leaves,
          "gradients_card_vs_cpu_max_abs": grad_err,
          "first_tree_identical": True, "arms": arms,
          "replayed_launches": replayed, "replay_max_abs_err": err})
    return err


def phase_train_ranking(seed, smi, docs=2_270_000, iters=30, timed_tree=2,
                        arm_iters=5):
    """The ranking cell at full width, the repo's second north star
    (bench.py ``run_ranking``): ``make_mslr_like(2 270 000, 136)``, the last
    10 % of the queries held out; lambdarank, 255 leaves, learning rate
    0.1, max_bin 63, NDCG@10, quantized gradients at 64 levels; ``iters``
    iterations through ``lightgbm_torch.train`` (fused), the counts read
    around the call (K2's int form and K4 launched, K2's float form and K3
    never); an eager arm of the same trees (text byte-identical); a short
    unquantized arm (K2) and a ``bagging_by_query`` arm (half the queries
    each iteration: compacted K2 int, K3); held-out ``predict`` through K1
    with NDCG@10 >= 0.75 (bench.py's gate).  One tree's K2 int and K4
    launches, one unquantized tree's K2 launches and one bagged tree's K2
    int and K3 launches are replayed bit-equal and timed beside their bound
    and library call; K1 against its plain version on the held-out rows and
    timed.  The gradients' share of a fused iteration is the objective's
    device time over the fused ``s_per_tree``; one eager iteration is
    timed phase by phase.
    Returns each kernel's ``ranking`` entry and the replays' largest
    differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.kernels import leaf_gather as lg
    from lightgbm_torch.kernels import predict as tpk
    from lightgbm_torch.kernels import route_replay as rr
    from lightgbm_torch.utils.timer import host_reads

    t0 = time.perf_counter()
    X, y, sizes = make_mslr_like(docs, 136, seed=11 + seed)
    q_split = int(len(sizes) * 0.9)
    d_split = int(np.sum(sizes[:q_split]))
    Xs, ys, ss = X[d_split:], y[d_split:], sizes[q_split:]
    data_s = time.perf_counter() - t0
    params = {"objective": "lambdarank", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 63, "verbosity": -1,
              "ndcg_eval_at": [10], "use_quantized_grad": True,
              "num_grad_quant_bins": 64}
    t0 = time.perf_counter()
    ds = lt.Dataset(X[:d_split], label=y[:d_split], group=sizes[:q_split],
                    params={"max_bin": 63})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    del X

    kernels.reset_launch_counts()
    r0 = host_reads()
    with TimedIters(capture_at=timed_tree) as timed:
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    reads = host_reads() - r0
    launches = kernels.launch_counts()
    eng = bst.engine
    leaves = [t.num_leaves for t in eng.models]
    if (bst.num_trees() != iters or not eng._fused
            or launches["route_and_hist_int"] == 0
            or launches["route_and_hist"] or launches["route_replay"]
            or launches["leaf_gather"] != iters):
        raise RuntimeError(f"ranking made {bst.num_trees()} trees (fused "
                           f"{eng._fused}) with launches {launches}")
    setup_s = data_s + construct_s

    # held-out prediction through K1, NDCG@10 (the north star's gate)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pred = bst.predict(Xs, raw_score=True)
    predict_s = time.perf_counter() - t0
    k1_launches = kernels.launch_counts()["predict_stream"]
    ndcg10 = ndcg_at_k(ys, pred, ss, 10)
    if not (k1_launches > 0 and pred.shape == (len(ys),)
            and np.isfinite(pred).all() and ndcg10 >= 0.75):
        raise RuntimeError(f"ranking predict: {k1_launches} K1 launches, "
                           f"held-out NDCG@10 {ndcg10}")
    from lightgbm_torch.config import Config
    from lightgbm_torch.metrics import NDCGMetric
    metric = NDCGMetric(Config.from_params(params))
    metric.init(ys, None, np.concatenate([[0], np.cumsum(ss)]))
    (_, metric_ndcg10, _), = metric.evaluate(pred, None)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    inp, _, k1_err = check_kernel_against_plain(bst, Xs)
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    k1_ms = device_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv,
                                                      words, maxd), reps=5)
    k1_plain = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    k1_bnd = bound(*k1_work(inp, use, maxd, len(ys)))
    del inp

    # the gradients alone, on the training score: the device's time (what
    # a graph replay costs) and, from an idle device, with the host's
    # enqueue of their kernels (what the eager iteration costs)
    score = eng.score[:eng.num_data]
    obj = eng.objective
    grad_ms = device_ms(lambda: obj.get_gradients(score), reps=5)
    grad_enqueue_ms = cuda_ms(lambda: obj.get_gradients(score), reps=5)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    obj.get_gradients(score)
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() - base_mem

    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n: lt.train({**params, **extra},
                                                      ds, n), iters)
    s_fused = fused["fused"]["s_per_tree"]

    # the unquantized arm: K2's float form
    kernels.reset_launch_counts()
    with TimedIters(capture_at=2) as float_t:
        float_bst = lt.train({**params, "use_quantized_grad": False}, ds,
                             arm_iters)
    float_launches = kernels.launch_counts()
    if (float_bst.num_trees() != arm_iters
            or float_launches["route_and_hist"] == 0
            or float_launches["route_and_hist_int"]):
        raise RuntimeError(f"ranking unquantized arm: {float_launches}")
    # bagging by query: compacted K2 int and K3
    kernels.reset_launch_counts()
    with TimedIters(capture_at=2) as bag_t:
        bag_bst = lt.train({**params, "bagging_by_query": True,
                            "bagging_fraction": 0.5, "bagging_freq": 1},
                           ds, arm_iters)
    bag_launches = kernels.launch_counts()
    if (bag_bst.num_trees() != arm_iters or not bag_bst.engine._fused
            or bag_bst.engine.last_compact_rows <= 0
            or bag_launches["route_replay"] != arm_iters):
        raise RuntimeError(f"ranking bagging_by_query arm: compact "
                           f"{bag_bst.engine.last_compact_rows}, launches "
                           f"{bag_launches}")
    bag_ndcg10 = ndcg_at_k(ys, bag_bst.predict(Xs, raw_score=True), ss, 10)

    replayed, err = replay_against_plain(timed.cap)
    replayed_f, err_f = replay_against_plain(float_t.cap)
    replayed_b, err_b = replay_against_plain(bag_t.cap)
    if not (replayed["route_and_hist_int"] and replayed_f["route_and_hist"]
            and replayed_b["route_replay"] and replayed["leaf_gather"]):
        raise RuntimeError(f"ranking replays: {replayed}, {replayed_f}, "
                           f"{replayed_b}")
    err = {k: max(v, err_f[k], err_b[k]) for k, v in err.items()}
    err["predict_stream"] = k1_err
    k2i = time_k2_launches([(a, o) for a, o in timed.cap.k2i if a[9]], True)
    k2i_route = time_k2_launches([(a, o) for a, o in timed.cap.k2i
                                  if not a[9]], True)
    k2i_bag = time_k2_launches([(a, o) for a, o in bag_t.cap.k2i if a[9]],
                               True)
    k2f = time_k2_launches([(a, o) for a, o in float_t.cap.k2 if a[10]],
                           False)
    (lid, vals), _ = timed.cap.k4[0]
    k4_ms = device_ms(lambda: lg.leaf_gather_cuda(lid, vals))
    k4_plain = device_ms(lambda: lg.leaf_gather_plain(lid, vals))
    k4_lib = device_ms(lambda: torch.index_select(vals, 0, lid))
    k4_bnd = bound(8.0 * lid.numel() + 4.0 * vals.numel(), lid.numel())
    (k3_bins, k3_tabs), _ = bag_t.cap.k3[0]
    k3_ms = device_ms(lambda: rr.route_replay_cuda(k3_bins, k3_tabs))
    k3_plain = cuda_ms(lambda: rr.route_replay_plain(k3_bins, k3_tabs),
                       reps=1, warmup=0)
    k3_bnd = bound(*k3_work(k3_bins, k3_tabs))

    # one eager iteration phase by phase: the gradients' share there
    eager = lt.train({**params, "fused_iter": "off"}, ds, 2)
    prof_s, prof_phases, prof_reads = profiled_iteration(eager)
    total = sum(prof_phases.values())
    fused_prof_s, fused_phases, _ = profiled_iteration(bst)
    emit({"phase": "train_ranking", "card": smi, "docs": docs,
          "train_docs": d_split, "queries": int(q_split),
          "held_out_docs": int(len(ys)), "held_out_queries": int(len(ss)),
          "features": 136, "groups": int(eng.dd.bins.shape[1]),
          "max_bins": int(eng.dd.max_bins), "iterations": iters,
          "num_leaves": 255, "num_grad_quant_bins": 64,
          "buckets": [[int(b.idx.shape[0]), int(b.idx.shape[1]),
                       b.span is not None]
                      for b in obj._device_buckets(score.device)],
          "setup_s": setup_s, "data_s": data_s, "construct_s": construct_s,
          "train_s": train_s, "s_per_tree": statistics.median(
              timed.seconds[1:]),
          "tree_s": timed.seconds,
          "leaves_per_tree": leaves, "launches": launches,
          "k2_int_launches_per_tree": launches["route_and_hist_int"] / iters,
          "held_out_ndcg10": ndcg10, "held_out_ndcg10_metric": metric_ndcg10,
          "predict_s": predict_s, "k1_launches": k1_launches,
          "gradients_ms": grad_ms, "gradients_enqueue_ms": grad_enqueue_ms,
          "gradients_share_of_fused_tree": grad_ms * 1e-3 / s_fused,
          "gradients_peak_bytes": int(grad_peak),
          "eager_iteration_s": prof_s, "eager_iteration_phases_s":
          prof_phases, "eager_iteration_phase_share": {
              k: v / total for k, v in prof_phases.items()} if total else {},
          "eager_iteration_host_reads": prof_reads,
          "fused_iteration_s": fused_prof_s,
          "fused_iteration_phases_s": fused_phases,
          "unquantized_arm": {"launches": float_launches,
                              "s_per_tree": statistics.median(
                                  float_t.seconds[1:])},
          "bagging_by_query_arm": {
              "launches": bag_launches, "compact_rows":
              bag_bst.engine.last_compact_rows,
              "s_per_tree": statistics.median(bag_t.seconds[1:]),
              "held_out_ndcg10": bag_ndcg10},
          "replayed_launches_timed_tree": replayed,
          "replayed_launches_unquantized_tree": replayed_f,
          "replayed_launches_bagged_tree": replayed_b,
          "replay_max_abs_err": err, "k2_int_full_hist": k2i,
          "k2_int_route_only": k2i_route, "k2_int_compacted": k2i_bag,
          "k2_full_hist": k2f, "k3_ms": k3_ms, "k3_plain_ms": k3_plain,
          "k4_ms": k4_ms, "k1_ms": k1_ms, "k1_plain_ms": k1_plain,
          "fused_iter": fused})

    def entry(launches_n, ms, plain, bnd, lib):
        return {"cell": "train_ranking", "launches": launches_n, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib}

    lines = {
        "route_and_hist_int": entry(
            launches["route_and_hist_int"], k2i["mean_ms"],
            k2i["mean_plain_ms"], (k2i["mean_bound_ms"], k2i["bound_by"]),
            k2i["mean_index_add_ms"]),
        "route_and_hist": entry(
            float_launches["route_and_hist"], k2f["mean_ms"],
            k2f["mean_plain_ms"], (k2f["mean_bound_ms"], k2f["bound_by"]),
            k2f["mean_index_add_ms"]),
        "route_replay": entry(bag_launches["route_replay"], k3_ms, k3_plain,
                              k3_bnd, None),
        "leaf_gather": entry(launches["leaf_gather"], k4_ms, k4_plain,
                             k4_bnd, k4_lib),
        "predict_stream": entry(k1_launches, k1_ms, k1_plain, k1_bnd, None)}
    return lines, err


# --------------------------------------------------------------------------
# the regression family, cross-entropy and leaf renewal
# --------------------------------------------------------------------------

# objective: (label kind of regression_labels, parameters); the first three
# renew their leaves (eager), the others fuse under stream on the card
REGRESSION_OBJECTIVES = {
    "regression_l1": ("continuous", {}),
    "quantile": ("continuous", {"alpha": 0.9}),
    "mape": ("continuous", {}),
    "huber": ("continuous", {}),
    "fair": ("continuous", {}),
    "poisson": ("count", {}),
    "tweedie": ("count", {"tweedie_variance_power": 1.5}),
    "gamma": ("gamma", {}),
    "cross_entropy": ("prob", {}),
    "cross_entropy_lambda": ("prob", {}),
}
RENEWING = ("regression_l1", "quantile", "mape")
# CPU against card on real gradients after the first tree (equal): raw
# scores within this share of their scale, max(1, max |score|) (binary's
# 2e-4 at train_small, scaled)
SMOOTH_SCORE_RTOL = 2e-4


def regression_labels(logit, seed):
    """Labels of the regression family from a generator's logit, drawn
    from ``seed`` with numpy: a continuous target with Laplace noise
    (regression_l1, quantile, huber, fair, mape), Poisson counts at rate
    exp(0.3 logit - 1) (poisson, tweedie), a gamma target of shape 2 and
    mean exp(0.3 logit) (gamma), and the probability sigmoid(1.2 logit) as
    a label in [0, 1] (cross_entropy, cross_entropy_lambda)."""
    rs = np.random.RandomState(seed)
    logit = np.asarray(logit, np.float64)
    n = len(logit)
    return {"continuous": logit + rs.laplace(scale=1.0, size=n),
            "count": rs.poisson(np.exp(0.3 * logit - 1.0)).astype(
                np.float64),
            "gamma": rs.gamma(2.0, np.exp(0.3 * logit) / 2.0),
            "prob": 1.0 / (1.0 + np.exp(-1.2 * logit))}


def pow2_labels(y):
    """|y| rounded to a power of two, the sign kept: 1 / max(1, |y|) is a
    power of two, so MAPE's gradients are dyadic and its weighted CDF
    exact."""
    return np.sign(y) * 2.0 ** np.round(np.log2(np.abs(y) + 1e-3))


def phase_train_regression_small(seed, n=20_000, iters=5, num_leaves=127):
    """The other objectives on both devices, on train_small's rows with
    labels from its logit (``regression_labels``), 127 leaves at a split
    budget of 64 (the route-only sprint round), ``iters`` iterations.
    regression_l1, quantile at alpha 0.75 and mape on labels whose
    1 / max(1, |y|) are powers of two have dyadic gradients and exact
    histograms, and the renewal picks order statistics (mape: an exact
    weighted CDF): their text must be byte-identical on the CPU and the
    card, also bagged (half the rows every iteration: compacted, K3).  The
    smooth objectives (huber, fair, poisson, tweedie, gamma, cross_entropy,
    cross_entropy_lambda) must grow the same first tree on both devices
    with raw scores within ``SMOOTH_SCORE_RTOL`` of their scale, and fuse on
    the card with text byte-identical to the card's eager run.  Every K2, K3
    and K4 launch of the card's main runs is replayed bit-equal through its
    plain version."""
    import torch
    import lightgbm_torch as lt

    X, _ = make_train_small(n, seed)
    labels = regression_labels(train_small_logit(X), seed + 11)
    base = {"num_leaves": num_leaves, "max_splits_per_round": 64,
            "max_bin": 63, "verbosity": -1}
    bagged = {"bagging_fraction": 0.5, "bagging_freq": 1}
    cap = Capture()
    arms = {}
    exact = {"regression_l1": ({}, labels["continuous"]),
             "quantile": ({"alpha": 0.75}, labels["continuous"]),
             "mape": ({}, pow2_labels(labels["continuous"]))}
    for name, (extra, y) in exact.items():
        for sampled in (False, True):
            texts = {}
            for dev in ("cpu", "cuda"):
                p = {**base, "objective": name, **extra,
                     **(bagged if sampled else {}), "device_type": dev}
                with (cap if dev == "cuda" else contextlib.nullcontext()):
                    bst = lt.train(p, lt.Dataset(X, label=y, params=p),
                                   iters)
                if bst.engine._fused or bst.num_trees() != iters:
                    raise RuntimeError(f"{name}: fused {bst.engine._fused}, "
                                       f"{bst.num_trees()} trees")
                texts[dev] = model_trees_text(bst)
            arm = name + ("_bagged" if sampled else "")
            if texts["cpu"] != texts["cuda"]:
                raise RuntimeError(f"{arm}: the CPU's and the card's text "
                                   "differ")
            if sampled and bst.engine.last_compact_rows <= 0:
                raise RuntimeError(f"{arm}: the sampled trees were not "
                                   "compacted")
            arms[arm] = {"text_identical": True,
                         "compact_rows": bst.engine.last_compact_rows,
                         "leaves_per_tree": [t.num_leaves
                                             for t in bst.engine.models]}
    for name, (kind, extra) in REGRESSION_OBJECTIVES.items():
        if name in RENEWING:
            continue
        y = labels[kind]
        runs = {}
        for dev, fused in (("cpu", "auto"), ("cuda", "auto"),
                           ("cuda", "off")):
            p = {**base, "objective": name, **extra, "device_type": dev,
                 "fused_iter": fused}
            with (cap if (dev, fused) == ("cuda", "auto")
                  else contextlib.nullcontext()):
                runs[dev, fused] = lt.train(
                    p, lt.Dataset(X, label=y, params=p), iters)
        cpu, card, eager = (runs[k] for k in (("cpu", "auto"),
                                              ("cuda", "auto"),
                                              ("cuda", "off")))
        if not card.engine._fused or eager.engine._fused:
            raise RuntimeError(f"{name}: fused {card.engine._fused} on the "
                               f"card, {eager.engine._fused} when off")
        if model_trees_text(card) != model_trees_text(eager):
            raise RuntimeError(f"{name}: fused and eager text differ on the "
                               "card")
        c_trees, g_trees = cpu.engine.models, card.engine.models
        if len(g_trees) != iters or \
                tree_structure(c_trees[0]) != tree_structure(g_trees[0]):
            raise RuntimeError(f"{name}: the first tree differs between "
                               "devices")
        s_cpu = cpu.engine.score[:n].numpy()
        s_card = card.engine.score[:n].cpu().numpy()
        gap = float(np.abs(s_cpu - s_card).max()) / max(
            1.0, float(np.abs(s_cpu).max()))
        if not (gap <= SMOOTH_SCORE_RTOL and np.isfinite(s_card).all()):
            raise RuntimeError(f"{name}: raw scores differ by {gap} of "
                               "their scale")
        arms[name] = {"fused": True, "fused_text_equals_eager": True,
                      "first_tree_identical": True,
                      "trees_differing_cpu_card": sum(
                          tree_structure(a) != tree_structure(b)
                          for a, b in zip(c_trees, g_trees)),
                      "max_score_gap_of_scale": gap}
    torch.cuda.synchronize()
    replayed, err = replay_against_plain(cap)
    if not (replayed["route_and_hist"] and replayed["route_replay"]
            and replayed["leaf_gather"]):
        raise RuntimeError(f"regression small: replayed {replayed}")
    emit({"phase": "train_regression_small", "rows": n, "iterations": iters,
          "num_leaves": num_leaves, "arms": arms,
          "replayed_launches": replayed, "replay_max_abs_err": err})
    return err


def held_out_metric(bst, name, params, Xh, yh):
    """The objective's default metric on the held-out rows: the model's,
    after ``predict`` on the card (K1, then ``convert_output``), and the
    constant model's (the init score alone); lower is better for every
    objective here.  Returns (metric name, model, constant, K1 launches)."""
    from lightgbm_torch import kernels
    from lightgbm_torch.config import Config
    from lightgbm_torch.metrics import create_metrics

    kernels.reset_launch_counts()
    pred = bst.predict(Xh)
    k1 = kernels.launch_counts()["predict_stream"]
    (metric,) = create_metrics(Config.from_params(params), name)
    metric.init(yh, None)
    obj = bst.engine.objective
    const = obj.convert_output(np.full(len(yh), bst.engine.init_scores[0],
                                       np.float32))
    (mname, model_v, _), = metric.evaluate(pred, lambda s: s)
    (_, const_v, _), = metric.evaluate(const, lambda s: s)
    if not (np.isfinite(pred).all() and pred.shape == (len(yh),)
            and k1 > 0 and model_v < const_v):
        raise RuntimeError(f"{name}: held-out {mname} {model_v} against the "
                           f"constant model's {const_v} ({k1} K1 launches)")
    return mname, model_v, const_v, k1


def phase_train_regression(seed, smi, ds, Xs, iters=20, held_out=250_000,
                           timed_tree=2, arm_iters=10):
    """The regression cell at full width: the full phase's held-out
    HIGGS-shaped rows (1M x 28) as ``Dataset(..., reference=ds)`` (its
    max_bin 63 mappers), the last ``held_out`` rows held out, labels from
    the generator's logit (``regression_labels``); 255 leaves, learning
    rate 0.1, split budget 64, ``iters`` iterations of each of the ten
    objectives through ``lightgbm_torch.train``, the counts read around
    each call.  regression_l1, quantile (alpha 0.9) and mape renew their
    leaves and train eager; the others fuse, and an eager arm of the same
    trees must give byte-identical text.  A bagged regression_l1 arm (half
    the rows: compacted, K3) and a quantized one (``use_quantized_grad``
    with ``quant_train_renew_leaf``: K2's int form, both renewals in turn).
    Every arm's held-out metric, after ``predict`` on the card, must beat
    the constant model's; the renewing objectives' first 3 trees must
    repeat byte for byte (mape's weighted sums are exact fixed point).  One tree of each arm is replayed bit-equal; the
    renewal, and ``torch.sort`` alone, are timed on one tree's leaves; one
    eager regression_l1 iteration is timed phase by phase.  Returns the
    kernels line's ``regression`` entries and the replays' largest
    differences."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.kernels import leaf_gather as lg
    from lightgbm_torch.kernels import predict as tpk
    from lightgbm_torch.kernels import route_replay as rr
    from lightgbm_torch.utils.timer import host_reads

    n_train = len(Xs) - held_out
    t0 = time.perf_counter()
    labels = regression_labels(higgs_logit(Xs), seed + 13)
    datasets = {}
    for kind, y in labels.items():
        datasets[kind] = lt.Dataset(Xs[:n_train], label=y[:n_train],
                                    reference=ds).construct()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    Xh = Xs[n_train:]
    base = {"num_leaves": 255, "learning_rate": 0.1,
            "max_splits_per_round": 64, "max_bin": 63, "verbosity": -1}
    arm_list = [(name, kind, extra, iters)
                for name, (kind, extra) in REGRESSION_OBJECTIVES.items()]
    arm_list += [("regression_l1_bagged", "continuous",
                  {"bagging_fraction": 0.5, "bagging_freq": 1}, arm_iters),
                 ("regression_l1_quantized", "continuous",
                  {"use_quantized_grad": True,
                   "quant_train_renew_leaf": True}, arm_iters)]
    arms, caps, results = {}, {}, {}
    errs = []
    for arm, kind, extra, n_iter in arm_list:
        name = arm.split("_bagged")[0].split("_quantized")[0]
        params = {**base, "objective": name, **extra}
        dsk = datasets[kind]
        kernels.reset_launch_counts()
        r0 = host_reads()
        with TimedIters(capture_at=timed_tree) as timed:
            t0 = time.perf_counter()
            bst = lt.train(params, dsk, n_iter)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        reads = host_reads() - r0
        launches = kernels.launch_counts()
        fuses = name not in RENEWING
        int_form = bool(extra.get("use_quantized_grad"))
        k2_name = "route_and_hist_int" if int_form else "route_and_hist"
        if (bst.num_trees() != n_iter or bst.engine._fused != fuses
                or launches[k2_name] == 0
                or launches["leaf_gather"] != n_iter
                or (int_form and launches["route_and_hist"])
                or ("bagging_fraction" in extra
                    and launches["route_replay"] == 0)):
            raise RuntimeError(f"{arm}: {bst.num_trees()} trees, fused "
                               f"{bst.engine._fused}, launches {launches}")
        metric, model_v, const_v, k1 = held_out_metric(
            bst, name, params, Xh, labels[kind][n_train:])
        if name in RENEWING and arm == name:
            # the renewal is exact fixed point and sorts: it repeats
            again = lt.train(params, dsk, 3)
            if model_trees_text(again) != model_trees_text(bst,
                                                           num_iteration=3):
                raise RuntimeError(f"{arm}: training does not repeat bit "
                                   "for bit")
        replayed, err = replay_against_plain(timed.cap)
        errs.append(err)
        entry = {"iterations": n_iter, "train_s": train_s,
                 "launches": launches,
                 "k2_launches_per_tree": launches[k2_name] / n_iter,
                 "k3_launches": launches["route_replay"],
                 "k4_launches": launches["leaf_gather"],
                 "held_out_metric": metric, "held_out": model_v,
                 "constant_model": const_v, "margin": const_v - model_v,
                 "k1_launches": k1,
                 "replayed_launches_timed_tree": replayed,
                 "leaves_per_tree": [t.num_leaves
                                     for t in bst.engine.models]}
        if name in RENEWING:
            # the renewal alone on the timed tree's own inputs (the score
            # before it, its leaves, its in-bag mask), and the stable sort
            # it starts with
            obj = bst.engine.objective
            (score, lid, n_leaves, in_bag), = timed.cap.renew
            entry["renew_ms"] = device_ms(
                lambda: obj.renew_leaf_values(score, lid, n_leaves, in_bag),
                reps=5)
            entry["sort_ms"] = device_ms(
                lambda: torch.sort(score, stable=True), reps=5)
            entry["renew_in_bag_rows"] = int(in_bag.sum().item())
        if fuses:
            entry["fused_iter"] = fused_and_eager(
                bst, timed, launches, reads,
                lambda x, k, p=params, d=dsk: lt.train({**p, **x}, d, k),
                n_iter)
        else:
            entry["fused_iter"] = {"eager": arm_numbers(bst, timed,
                                                        launches, reads)}
        s_tree = entry["fused_iter"]["eager"]["s_per_tree"]
        if "renew_ms" in entry:
            entry["renew_share_of_eager_tree"] = \
                entry["renew_ms"] * 1e-3 / s_tree
        arms[arm] = entry
        caps[arm] = timed.cap
        results[arm] = bst
    err = {k: max(e[k] for e in errs) for k in errs[0]}

    # one eager regression_l1 iteration phase by phase (the renewal apart)
    prof_s, prof_phases, prof_reads = profiled_iteration(
        results["regression_l1"])

    # the kernels line's regression entries: K2 from regression_l1's timed
    # tree, K2 int from the quantized arm's, K3 from the bagged arm's, K4,
    # and K1 on the held-out rows of regression_l1
    cap = caps["regression_l1"]
    k2f = time_k2_launches([(a, o) for a, o in cap.k2 if a[10]], False)
    qcap = caps["regression_l1_quantized"]
    k2i = time_k2_launches([(a, o) for a, o in qcap.k2i if a[9]], True)
    (lid, vals), _ = cap.k4[0]
    k4_ms = device_ms(lambda: lg.leaf_gather_cuda(lid, vals))
    k4_plain = device_ms(lambda: lg.leaf_gather_plain(lid, vals))
    k4_lib = device_ms(lambda: torch.index_select(vals, 0, lid))
    k4_bnd = bound(8.0 * lid.numel() + 4.0 * vals.numel(), lid.numel())
    (k3_bins, k3_tabs), _ = caps["regression_l1_bagged"].k3[0]
    k3_ms = device_ms(lambda: rr.route_replay_cuda(k3_bins, k3_tabs))
    k3_plain = cuda_ms(lambda: rr.route_replay_plain(k3_bins, k3_tabs),
                       reps=1, warmup=0)
    k3_bnd = bound(*k3_work(k3_bins, k3_tabs))
    bst = results["regression_l1"]
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    inp, _, k1_err = check_kernel_against_plain(bst, Xh)
    err["predict_stream"] = k1_err
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    k1_ms = device_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv,
                                                      words, maxd), reps=5)
    k1_plain = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    k1_bnd = bound(*k1_work(inp, use, maxd, len(Xh)))
    del inp
    emit({"phase": "train_regression", "card": smi, "rows": int(n_train),
          "held_out_rows": int(len(Xh)), "features": int(Xs.shape[1]),
          "num_leaves": 255, "max_bin": 63, "setup_s": setup_s,
          "arms": arms, "replay_max_abs_err": err,
          "eager_l1_iteration_s": prof_s,
          "eager_l1_iteration_phases_s": prof_phases,
          "eager_l1_iteration_host_reads": prof_reads,
          "k2_full_hist": k2f, "k2_int_full_hist": k2i, "k3_ms": k3_ms,
          "k3_plain_ms": k3_plain, "k4_ms": k4_ms, "k1_ms": k1_ms,
          "k1_plain_ms": k1_plain})

    def entry(launches_n, ms, plain, bnd, lib):
        return {"cell": "train_regression", "launches": launches_n,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib}

    l1 = arms["regression_l1"]
    lines = {
        "route_and_hist": entry(
            l1["launches"]["route_and_hist"], k2f["mean_ms"],
            k2f["mean_plain_ms"], (k2f["mean_bound_ms"], k2f["bound_by"]),
            k2f["mean_index_add_ms"]),
        "route_and_hist_int": entry(
            arms["regression_l1_quantized"]["launches"]["route_and_hist_int"],
            k2i["mean_ms"], k2i["mean_plain_ms"],
            (k2i["mean_bound_ms"], k2i["bound_by"]),
            k2i["mean_index_add_ms"]),
        "route_replay": entry(
            arms["regression_l1_bagged"]["launches"]["route_replay"], k3_ms,
            k3_plain, k3_bnd, None),
        "leaf_gather": entry(l1["launches"]["leaf_gather"], k4_ms, k4_plain,
                             k4_bnd, k4_lib),
        "predict_stream": entry(l1["k1_launches"], k1_ms, k1_plain, k1_bnd,
                                None)}
    return lines, err


# --------------------------------------------------------------------------
# the prediction surface: pred_leaf (K1's leaf form) and pred_contrib
# (TreeSHAP)
# --------------------------------------------------------------------------

def host_leaves(use, X):
    """(N, trees) int32 leaf of every row in every tree: the float64 host
    walk (``Tree.predict_leaf_raw``), as the CPU's ``predict`` runs it."""
    X = np.asarray(X, np.float64)
    out = np.zeros((X.shape[0], len(use)), np.int32)
    for i, t in enumerate(use):
        out[:, i] = t.predict_leaf_raw(X)
    return out


def row_scale(c):
    """Each row's scale for the SHAP tolerances: its largest contribution,
    at least 1."""
    return np.maximum(np.abs(c).max(axis=1, keepdims=True), 1.0)


def shap_inputs(use, X, k, depth, dev):
    """The device TreeSHAP's operands on ``dev``, as
    ``shap.predict_contrib_device`` builds them."""
    import torch
    from lightgbm_torch import shap as tshap
    from lightgbm_torch.kernels import tree_shap as kts

    host, base = tshap.shap_tables(use, k, depth)
    tabs = kts.ShapTables(*(torch.as_tensor(a).to(dev) for a in host))
    X_T = torch.as_tensor(np.ascontiguousarray(
        np.asarray(X, np.float64).T)).to(dev)
    return X_T, tabs, host


def check_shap_kernel(X_T, tabs, k):
    """The TreeSHAP kernel against its plain version on the card (within
    1e-10 of each row's scale) and against itself (byte-identical).
    Returns the kernel's output and the largest difference."""
    import torch
    from lightgbm_torch.kernels import tree_shap as kts

    got = kts.tree_shap_cuda(X_T, tabs, k)
    again = kts.tree_shap_cuda(X_T, tabs, k)
    want = kts.tree_shap_plain(X_T, tabs, k)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError("a repeated TreeSHAP launch gave other bytes")
    g = got.reshape(got.shape[0], -1).cpu().numpy()
    w = want.reshape(want.shape[0], -1).cpu().numpy()
    diff = np.abs(g - w)
    if not (diff <= 1e-10 * row_scale(w)).all():
        raise RuntimeError(f"TreeSHAP kernel differs from its plain version "
                           f"(max abs {diff.max()})")
    return got, float(diff.max()) if diff.size else 0.0


def shap_work(tabs, X_T, k, chunk=20_000):
    """Bytes and float64 operations of one TreeSHAP launch on these rows,
    counted from their data (an FMA two operations): a (row, leaf) of d
    slots, h of them hot (every occurrence going the row's way), extends
    its path polynomial in sum_k k (1 + 2 o_k) operations (a multiply a
    step, an FMA where slot k is hot), takes the cold slots' common sum in
    2 d where a slot is cold, unwinds each hot slot in 4 d and gives it 3
    more (its share of the leaf value, the add), and each cold slot 4; the
    rows read and the (K, F + 1) contributions written once, the tables
    read once.  Also the operations of the textbook count the bound was
    taken from before, 3 d (d + 1) + 5 d^2 a (row, leaf)."""
    import torch
    from lightgbm_torch.kernels import tree_shap as kts

    F, n = X_T.shape
    T, L, D = tabs.feat.shape
    f64 = torch.float64
    kk = torch.arange(1, D + 1, device=X_T.device, dtype=f64)
    n_ops = 0.0
    for t in range(T):
        d = tabs.plen[t].to(f64)                                # (L,)
        valid = kk[None, :] <= d[:, None]                       # (L, D)
        for s in range(0, n, chunk):
            hot = kts.hot_slots_plain(X_T[:, s:s + chunk], tabs, t) & valid
            h = hot.sum(dim=2, dtype=f64)                       # (m, L)
            ext = (kk * valid).sum(1) + 2 * (kk * hot).sum(2)
            ops = (ext + torch.where(h < d, 2 * d, 0.0) + h * (4 * d + 3)
                   + (d - h) * 4)
            n_ops += float(ops.sum())
    dd = tabs.plen.to(f64)
    textbook = n * float((3.0 * dd * (dd + 1) + 5.0 * dd * dd).sum())
    n_bytes = (X_T.numel() * 8 + n * k * (F + 1) * 8
               + sum(a.numel() * a.element_size() for a in tabs))
    return n_bytes, n_ops, textbook


def phase_predict_surface_small(seed, n=20_000, iters=5, num_leaves=31):
    """pred_leaf and pred_contrib on the card against the CPU's host walks,
    on models trained on the card over 20 000 rows: K1's leaf form equal to
    the host walk leaf for leaf (binary with NaN, zero-as-missing, K = 3,
    categorical, 16-bit bins); the TreeSHAP kernel within 1e-10 of its
    plain version, within 1e-9 of the exact host walk, byte-identical when
    repeated; the stock fixtures; a categorical model on the host walk;
    a leaf-wise model whose paths reach 20-24 unique slots
    (``shap_deep_case``)."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch import shap as tshap

    X, y = make_train_small(n, seed)
    Xp, _ = make_train_small(n, seed + 1)
    Xc, yc = make_categorical_small(n, seed)
    Xcp, _ = make_categorical_small(n, seed + 1)
    Xw, yw = make_wide_small(n, seed)
    Xwp, _ = make_wide_small(n, seed + 1)
    y3 = np.digitize(train_small_logit(X), [-1.0, 1.0]).astype(np.float64)
    # max_bin 63 keeps train_small's EFB bundle within uint8 bins; the
    # wide rows bundle past 256 bins at the default 255
    base = {"num_leaves": num_leaves, "verbosity": -1, "max_bin": 63}
    cases = [("binary_nan", X, y, Xp, {"objective": "binary"}, {}),
             ("zero_as_missing", X, y, Xp,
              {"objective": "binary", "zero_as_missing": True}, {}),
             ("multiclass", X, y3, Xp,
              {"objective": "multiclass", "num_class": 3}, {}),
             ("categorical", Xc, yc, Xcp, {"objective": "binary"},
              {"categorical_feature": CAT_SMALL}),
             ("wide", Xw, yw, Xwp, {"objective": "binary", "max_bin": 255},
              {})]
    results, err = [], 0.0
    for name, Xt, yt, Xq, obj, ds_kw in cases:
        params = {**base, **obj}
        bst = lt.train(params, lt.Dataset(Xt, label=yt,
                                          params=dict(params), **ds_kw),
                       iters)
        use, k, _, _ = bst._resolve_tree_slice(0, None)
        kernels.reset_launch_counts()
        leaf = bst.predict(Xq, pred_leaf=True)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wide = kernels.wide_launch_counts()["predict_leaf"]
        if launches["predict_leaf"] != k or (name == "wide") != (
                wide == k):
            raise RuntimeError(f"{name}: pred_leaf launched {launches}, "
                               f"{wide} over 16-bit bins")
        if not np.array_equal(leaf, host_leaves(use, Xq)):
            raise RuntimeError(f"{name}: K1's leaf form differs from "
                               f"the host walk")
        row = {"case": name, "k": k, "trees": len(use),
               "leaf_launches": launches["predict_leaf"],
               "wide_launches": wide, "leaf_equals_host": True}
        kernels.reset_launch_counts()
        contrib = bst.predict(Xq, pred_contrib=True)
        torch.cuda.synchronize()
        shap_launches = kernels.launch_counts()["tree_shap"]
        host = tshap.predict_contrib(use, np.asarray(Xq, np.float64), k)
        depth = tshap.device_depth(use)
        if name == "categorical":
            # categorical trees: the exact host walk, no launch
            if shap_launches or depth or \
                    contrib.tobytes() != host.tobytes():
                raise RuntimeError(f"categorical pred_contrib launched "
                                   f"{shap_launches} (depth {depth})")
        else:
            if shap_launches != 1:
                raise RuntimeError(f"{name}: TreeSHAP launched "
                                   f"{shap_launches}")
            diff = np.abs(contrib - host)
            if not (diff <= 1e-9 * row_scale(host)).all():
                raise RuntimeError(f"{name}: TreeSHAP differs from the "
                                   f"host walk (max abs {diff.max()})")
            X_T, tabs, _ = shap_inputs(use, Xq, k, depth,
                                       bst.engine.device)
            _, e = check_shap_kernel(X_T, tabs, k)
            err = max(err, e)
            row.update(max_raw_depth=depth, shap_max_abs_vs_host=float(
                diff.max()), shap_max_abs_vs_plain=e)
        row["shap_launches"] = shap_launches
        results.append(row)
    # the stock LightGBM fixtures: leaf ids exact, contributions within
    # 1e-12 through the kernel (a loaded model on the card's device)
    fix = Path(__file__).resolve().parent / "tests" / "fixtures"
    Xg = np.asarray([[np.nan if v == "" else float(v)
                      for v in line.split(",")]
                     for line in (fix / "golden_X.csv").read_text()
                     .splitlines()])
    stock = lt.Booster(model_file=str(fix / "stock_binary.model"))
    kernels.reset_launch_counts()
    contrib = stock.predict(Xg, pred_contrib=True)
    torch.cuda.synchronize()
    if kernels.launch_counts()["tree_shap"] != 1:
        raise RuntimeError("the stock model's pred_contrib did not "
                           "launch TreeSHAP")
    want = np.loadtxt(fix / "stock_pred_binary_contrib.txt")
    stock_err = float(np.abs(contrib - want).max())
    leaf_ok = np.array_equal(stock.predict(Xg, pred_leaf=True),
                             np.loadtxt(fix / "stock_pred_binary_leaf.txt"))
    if stock_err > 1e-12 or not leaf_ok:
        raise RuntimeError(f"stock fixtures: contrib max abs "
                           f"{stock_err}, leaves equal {leaf_ok}")
    deep = shap_deep_case(seed, n)
    err = max(err, deep["shap_max_abs_vs_plain"])
    emit({"phase": "predict_surface_small", "rows": n, "cases": results,
          "deep": deep, "stock_contrib_max_abs": stock_err,
          "stock_leaf_exact": True, "tree_shap_max_abs_vs_plain": err})
    return {"tree_shap": err}


def make_deep_small(n, seed, F=28):
    """Rows whose leaf-wise trees run deep over distinct features: 28
    standard normal columns and the label exp(3 min_j x_j), which only a
    path bounding most features from below isolates."""
    rs = np.random.RandomState(seed + 29)
    X = rs.randn(n, F)
    return X, np.exp(3.0 * X.min(axis=1))


def shap_deep_case(seed, n, iters=3, host_rows=1_000, min_slots=20):
    """TreeSHAP on paths of 20-24 unique slots: a leaf-wise model (split
    budget 1, 255 leaves, max_depth 24) trained on the card over
    make_deep_small's rows, pred_contrib of ``n`` other rows through the
    kernel (one launch), within 1e-10 of its plain version and
    byte-identical repeated on all rows, within 1e-9 of the exact host
    walk on ``host_rows``; the same rows in chunks of 4096 (one launch a
    chunk) give the same bytes."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch import shap as tshap

    X, y = make_deep_small(n, seed)
    Xq, _ = make_deep_small(n, seed + 1)
    params = {"objective": "regression", "num_leaves": 255,
              "min_data_in_leaf": 1, "max_depth": 24,
              "max_splits_per_round": 1, "max_bin": 63, "verbosity": -1}
    bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params)),
                   iters)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    depth = tshap.device_depth(use)
    kernels.reset_launch_counts()
    contrib = bst.predict(Xq, pred_contrib=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["tree_shap"]
    X_T, tabs, host_tabs = shap_inputs(use, Xq, 1, depth, bst.engine.device)
    slots = int(host_tabs.plen.max())
    if launches != 1 or slots < min_slots:
        raise RuntimeError(f"deep TreeSHAP: {launches} launches, paths of "
                           f"{slots} slots (depth {depth})")
    _, e = check_shap_kernel(X_T, tabs, 1)
    exact = tshap.predict_contrib(use, Xq[:host_rows], 1)
    diff = np.abs(contrib[:host_rows] - exact)
    if not (diff <= 1e-9 * row_scale(exact)).all():
        raise RuntimeError(f"deep TreeSHAP differs from the host walk "
                           f"(max abs {diff.max()})")
    chunk_rows = 4096
    kernels.reset_launch_counts()
    chunked = tshap.predict_contrib_device(
        use, Xq, 1, bst.engine.device, depth,
        chunk_bytes=chunk_rows * 8 * (2 * Xq.shape[1] + 1))
    torch.cuda.synchronize()
    chunk_launches = kernels.launch_counts()["tree_shap"]
    if chunk_launches != -(-n // chunk_rows) or \
            chunked.tobytes() != contrib.tobytes():
        raise RuntimeError(f"TreeSHAP in {chunk_launches} row chunks "
                           f"differs from one launch")
    return {"trees": len(use), "leaves": [t.num_leaves for t in use],
            "max_raw_depth": max(tshap._raw_tree_depth(t) for t in use),
            "max_path_slots": slots,
            "leaves_with_20_slots_or_more": int((host_tabs.plen >= 20).sum()),
            "shap_launches": launches, "shap_max_abs_vs_plain": e,
            "host_rows": host_rows,
            "shap_max_abs_vs_host": float(diff.max()),
            "chunk_rows": chunk_rows, "chunk_launches": chunk_launches,
            "chunks_byte_identical": True}


def phase_predict_surface(smi, full_bst, ds, Xs, leaf_rows=200_000,
                          sub_rows=20_000, iters=20, shap_rows=100_000,
                          plain_rows=10_000, host_rows=2_000, gate_trees=2,
                          gate_rows=(1, 256)):
    """The prediction surface at full width: pred_leaf of phase full's
    500 x 255-leaf model on ``leaf_rows`` of its rows (K1's leaf form), and
    pred_contrib of a binary 255-leaf model of ``iters`` trees trained as
    the Train cell trains on its 1M rows, on ``shap_rows`` held-out rows
    (TreeSHAP), each with the kernel counts read around its ``predict``.
    Returns K1's ``leaf`` entry and the ``tree_shap`` entry of the kernels
    line."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch import shap as tshap
    from lightgbm_torch.basic import _host_predict, _to_2d_float
    from lightgbm_torch.kernels import build
    from lightgbm_torch.kernels import predict as tpk
    from lightgbm_torch.kernels import tree_shap as kts

    # pred_leaf: K1's leaf form over phase full's model
    X2 = Xs[:leaf_rows]
    use, _, _, _ = full_bst._resolve_tree_slice(0, None)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    leaf = full_bst.predict(X2, pred_leaf=True)
    leaf_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if (leaf.shape != (leaf_rows, len(use)) or leaf.dtype != np.int32
            or launches["predict_leaf"] != 1 or launches["bin_rows"] == 0
            or launches["predict_stream"] != 0):
        raise RuntimeError(f"pred_leaf: shape {leaf.shape}, launches "
                           f"{launches}")
    t0 = time.perf_counter()
    host = host_leaves(use, X2[:sub_rows])
    host_s = time.perf_counter() - t0
    if not np.array_equal(leaf[:sub_rows], host):
        raise RuntimeError("K1's leaf form differs from the host walk")
    inp = full_bst._device_predict_inputs(_to_2d_float(X2)[0], use, 1)
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    out = torch.empty((leaf_rows, len(use)), dtype=torch.int32,
                      device=inp.bins_T.device)
    plain = torch.empty_like(out)
    ms = device_ms(lambda: tpk.predict_leaf_cuda(inp.bins_T, nodes, lv, words,
                                                 maxd, out), reps=5)
    plain_ms = cuda_ms(lambda: tpk.predict_leaf_plain(inp.bins_T, nodes,
                                                      words, depths, plain),
                       reps=1, warmup=0)
    if not (torch.equal(out, plain)
            and np.array_equal(out.cpu().numpy(), leaf)):
        raise RuntimeError("K1's leaf form differs from its plain version")
    # the planes the leaf walk reads: every node's two walk words, the nine
    # other words of its special nodes (route_special), the bitset words;
    # never the leaf values
    _, T, L = nodes.shape
    n_special = int((nodes[1] < 0).sum())
    n_bytes = (inp.bins_T.numel() * inp.bins_T.element_size()
               + 4 * (2 * T * L + (nodes.shape[0] - 2) * n_special)
               + words.numel() * 4 + out.numel() * 4)
    leaf_entry = {"launches": launches["predict_leaf"], "rows": leaf_rows,
                  "trees": len(use), "max_abs_err": 0.0, "ms": ms,
                  "plain_ms": plain_ms,
                  "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                  "bound_by": "bytes", "library_ms": None,
                  "source": KERNEL_SOURCES["predict_leaf"],
                  "replaces": KERNEL_REPLACES["predict_leaf"]}
    del inp, out, plain

    # pred_contrib: the Train cell's model, depth-capped if the kernel
    # cannot take it
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "verbosity": -1}
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    raw_depth = max(tshap._raw_tree_depth(t) for t in use)
    capped = tshap.device_depth(use) == 0
    if capped:
        params["max_depth"] = kts.MAX_DEPTH
        bst = lt.train(params, ds, iters)
        use, _, _, _ = bst._resolve_tree_slice(0, None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    depth = tshap.device_depth(use)
    if not depth:
        raise RuntimeError(f"the TreeSHAP model is {raw_depth} deep")
    Xh = np.asarray(Xs[-shap_rows:], np.float64)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    contrib = bst.predict(Xh, pred_contrib=True)
    contrib_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if contrib.shape != (shap_rows, Xh.shape[1] + 1) or \
            launches["tree_shap"] != 1 or not np.isfinite(contrib).all():
        raise RuntimeError(f"pred_contrib: shape {contrib.shape}, launches "
                           f"{launches}")
    X_T, tabs, host_tabs = shap_inputs(use, Xh, 1, depth, bst.engine.device)
    got = kts.tree_shap_cuda(X_T, tabs, 1)
    again = kts.tree_shap_cuda(X_T, tabs, 1)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and np.array_equal(
            got[:, 0, :-1].cpu().numpy(), contrib[:, :-1])):
        raise RuntimeError("TreeSHAP launches are not byte-identical")
    del got, again
    ms_shap = device_ms(lambda: kts.tree_shap_cuda(X_T, tabs, 1), reps=3)
    X_Tp = X_T[:, :plain_rows].contiguous()
    _, err = check_shap_kernel(X_Tp, tabs, 1)
    ms_plain_rows = device_ms(lambda: kts.tree_shap_cuda(X_Tp, tabs, 1),
                              reps=3)
    shap_plain_ms = cuda_ms(lambda: kts.tree_shap_plain(X_Tp, tabs, 1),
                            reps=1, warmup=0)
    t0 = time.perf_counter()
    exact = tshap.predict_contrib(use, Xh[:host_rows], 1)
    host_shap_s = time.perf_counter() - t0
    diff = np.abs(contrib[:host_rows] - exact)
    if not (diff <= 1e-9 * row_scale(exact)).all():
        raise RuntimeError(f"TreeSHAP differs from the exact host walk "
                           f"(max abs {diff.max()})")
    # the device path against the host walk at small batches, on the first
    # ``gate_trees`` trees: why no batch size gates pred_contrib
    gate = {"trees": gate_trees, "rows": list(gate_rows), "host_walk_s": [],
            "device_s": []}
    for r in gate_rows:
        t0 = time.perf_counter()
        tshap.predict_contrib(use[:gate_trees], Xh[:r], 1)
        gate["host_walk_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        bst.predict(Xh[:r], pred_contrib=True, num_iteration=gate_trees)
        gate["device_s"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    bst.predict(Xh[:1], pred_contrib=True)
    gate["device_s_one_row_all_trees"] = time.perf_counter() - t0
    raw64 = _host_predict(Xh, use, 1, False, 10, 10.0)
    add_err = np.abs(contrib.sum(axis=1) - raw64)
    if not (add_err <= 1e-9 * np.maximum(np.abs(raw64), 1.0)).all():
        raise RuntimeError(f"contributions do not sum to the raw score "
                           f"(max abs {add_err.max()})")
    np.testing.assert_allclose(contrib.sum(axis=1),
                               bst.predict(Xh, raw_score=True),
                               rtol=RTOL, atol=ATOL)
    n_bytes, n_ops, textbook_ops = shap_work(tabs, X_T, 1)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP64_OPS_PER_S * 1e3
    T, L, D = host_tabs.feat.shape
    plans = {"rows": list(kts.shap_plan(shap_rows, T, kts.SMS,
                                        X_T.shape[0], L, D)),
             "plain_rows": list(kts.shap_plan(plain_rows, T, kts.SMS,
                                              X_T.shape[0], L, D))}
    shap_entry = {"name": "tree_shap", "route": "cuda",
                  "source": KERNEL_SOURCES["tree_shap"],
                  "replaces": KERNEL_REPLACES["tree_shap"],
                  "launches": launches["tree_shap"],
                  "max_abs_err": err, "ms": ms_shap,
                  "plain_ms": shap_plain_ms, "plain_rows": plain_rows,
                  "ms_plain_rows": ms_plain_rows,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "library_ms": None, "plan": plans}
    emit({"phase": "predict_surface", "card": smi,
          "leaf": {"rows": leaf_rows, "trees": leaf_entry["trees"],
                   "predict_s": leaf_s,
                   "kernel_ms": ms, "plain_ms": plain_ms,
                   "bound_ms": leaf_entry["bound_ms"],
                   "host_walk_rows": sub_rows, "host_walk_s": host_s,
                   "equals_host": True},
          "contrib": {"rows": shap_rows, "trees": len(use),
                      "max_raw_depth": raw_depth,
                      "max_depth_param": (kts.MAX_DEPTH if capped
                                          else None),
                      "kernel_depth": depth, "train_s": train_s,
                      "predict_s": contrib_s, "kernel_ms": ms_shap,
                      "kernel_ms_plain_rows": ms_plain_rows,
                      "plain_rows": plain_rows, "plain_ms": shap_plain_ms,
                      "max_abs_vs_plain": err,
                      "host_rows": host_rows, "host_walk_s": host_shap_s,
                      "max_abs_vs_host": float(diff.max()),
                      "additivity_max_abs": float(add_err.max()),
                      "repeat_byte_identical": True,
                      "ops": n_ops, "bytes": n_bytes,
                      "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
                      "textbook_ops": textbook_ops,
                      "bound_textbook_ms": textbook_ops / FP64_OPS_PER_S
                      * 1e3, "plan": plans,
                      "gate": gate}})
    return leaf_entry, shap_entry


def shap_tree(rs, left, right, feature, n_feat, leaf_count=None):
    """A numeric Tree from its child arrays (a child < 0 is leaf ~child):
    node i splits ``feature[i]`` at a threshold in [-0.6, 0.6] (some exactly
    0.0), its missing type i % 3 (none, zero, nan), default left at every
    other node; leaf counts from ``rs`` unless given (a 0 makes a zero
    fraction of 0), internal counts their sums, leaf values from ``rs``."""
    from lightgbm_torch.tree import Tree

    left, right = np.asarray(left), np.asarray(right)
    ni = len(left)
    nl = ni + 1
    lc = (rs.randint(1, 60, nl).astype(np.float64) if leaf_count is None
          else np.asarray(leaf_count, np.float64))
    ic = np.zeros(ni)

    def count(c):
        return lc[~c] if c < 0 else ic[c]

    for i in range(ni - 1, -1, -1):   # children come after their parents
        ic[i] = count(left[i]) + count(right[i])
    thr = np.round(rs.uniform(-0.6, 0.6, ni), 3)
    thr[::5] = 0.0
    dt = np.array([Tree.make_decision_type(False, i % 2 == 0, i % 3)
                   for i in range(ni)], np.uint8)
    return Tree(num_leaves=nl, split_feature=np.asarray(feature) % n_feat,
                threshold_bin=np.zeros(ni, np.int32), threshold=thr,
                decision_type=dt, left_child=left, right_child=right,
                split_gain=np.ones(ni), internal_value=np.zeros(ni),
                internal_weight=ic, internal_count=ic,
                leaf_value=rs.randn(nl), leaf_weight=lc, leaf_count=lc)


def shap_chain(rs, n_int, features, n_feat):
    """A zigzag chain of ``n_int`` nodes over ``features`` (each node keeps
    one leaf child): its deepest leaves' paths hold as many unique slots
    as distinct features among them."""
    i = np.arange(n_int)
    left = np.where(i % 2 == 0, ~i, i + 1)
    right = np.where(i % 2 == 0, i + 1, ~i)
    left[-1], right[-1] = ~(n_int - 1), ~n_int
    return shap_tree(rs, left, right, np.asarray(features)[i], n_feat)


def shap_balanced(rs, depth, n_feat, zero_leaves=0):
    """A full tree of ``depth`` levels over random features, nodes in
    breadth-first order; ``zero_leaves`` of its leaves with count 0 (slots
    of zero fraction 0, and a node of weight 0 where two meet)."""
    ni = 2 ** depth - 1
    left = [2 * i + 1 if 2 * i + 1 < ni else ~(2 * i + 1 - ni)
            for i in range(ni)]
    right = [2 * i + 2 if 2 * i + 2 < ni else ~(2 * i + 2 - ni)
             for i in range(ni)]
    lc = rs.randint(1, 60, ni + 1).astype(np.float64)
    lc[:zero_leaves] = 0.0
    return shap_tree(rs, left, right, rs.randint(0, n_feat, ni), n_feat,
                     leaf_count=lc)


def shap_adversarial_trees(seed, n_feat=24):
    """Trees for TreeSHAP's edge cases: a single leaf (a path of 1 lane), a
    stump (2), two slots (3), chains of 23 and 24 unique slots (24 and 25
    lanes, the kernel's most), a 24-deep chain over 7 features (a feature
    repeated on one path), full trees of 6 levels with leaves of count 0
    (zero fractions 0, a node of weight 0)."""
    from lightgbm_torch.tree import Tree

    rs = np.random.RandomState(seed + 41)
    single = Tree(num_leaves=1, split_feature=np.zeros(0, np.int32),
                  threshold_bin=np.zeros(0, np.int32),
                  threshold=np.zeros(0), decision_type=np.zeros(0, np.uint8),
                  left_child=np.zeros(0, np.int32),
                  right_child=np.zeros(0, np.int32), split_gain=np.zeros(0),
                  internal_value=np.zeros(0), internal_weight=np.zeros(0),
                  internal_count=np.zeros(0), leaf_value=np.array([0.25]),
                  leaf_weight=np.ones(1), leaf_count=np.ones(1))
    return [single,
            shap_tree(rs, [~0], [~1], [3], n_feat),
            shap_tree(rs, [1, ~1], [~0, ~2], [5, 6], n_feat),
            shap_chain(rs, 23, np.arange(23), n_feat),
            shap_chain(rs, 24, np.arange(24), n_feat),
            shap_chain(rs, 24, np.arange(24) % 7, n_feat),
            shap_balanced(rs, 6, n_feat, zero_leaves=2),
            shap_balanced(rs, 6, n_feat, zero_leaves=5)]


def shap_adversarial_rows(seed, n, n_feat=24):
    """Rows whose values sit where the decisions turn: NaN, +0.0, -0.0,
    +-1e-36 (missing under zero-as-missing), the thresholds' own values
    and draws around them."""
    rs = np.random.RandomState(seed + 43)
    X = np.round(rs.uniform(-0.7, 0.7, (n, n_feat)), 3)
    special = np.array([np.nan, 0.0, -0.0, 1e-36, -1e-36, 0.6, -0.6])
    pick = rs.rand(n, n_feat) < 0.25
    X[pick] = rs.choice(special, int(pick.sum()))
    return X


def phase_shap_adversarial(seed, rows=(1, 31, 33, 10_000)):
    """The TreeSHAP kernel on ``shap_adversarial_trees`` (K = 1, and K = 3
    with the trees dealt to three classes) over ``rows`` of
    ``shap_adversarial_rows``: within 1e-10 of each row's scale of its
    plain version, within 1e-9 of the exact host walk, contributions
    summing to the float64 raw score of the host walk within 1e-9, a
    repeated launch
    byte-identical; the first rows of the largest launch byte-identical to
    the smaller launches (plans of many tree groups), and the largest
    launch the same bytes under one tree group, without shared decision
    words, with its accumulators in device memory, and in row chunks of
    4096.  Outside any main path's launch
    counts.  Returns the largest difference from the plain version."""
    import torch
    from lightgbm_torch import shap as tshap
    from lightgbm_torch.basic import _host_predict
    from lightgbm_torch.kernels import tree_shap as kts

    dev = torch.device("cuda")
    trees = shap_adversarial_trees(seed)
    X = shap_adversarial_rows(seed, max(rows))
    depth = tshap.device_depth(trees)
    if depth != kts.MAX_DEPTH:
        raise RuntimeError(f"adversarial trees {depth} deep")
    cases, err = [], 0.0
    for k, use in ((1, trees), (3, trees[1:] + trees[:1])):
        host_tabs, base = tshap.shap_tables(use, k, depth)
        T, L, D = host_tabs.feat.shape
        longest = set(host_tabs.plen.max(axis=1).tolist())
        if not ({1, 2, 7, 23, 24} <= longest
                and (host_tabs.zfrac[host_tabs.feat >= 0] == 0).any()):
            raise RuntimeError(f"adversarial tables: paths of {longest} "
                               f"slots")
        whole = None
        for n in sorted(rows, reverse=True):
            Xn = X[:n]
            X_T, tabs, _ = shap_inputs(use, Xn, k, depth, dev)
            got, e = check_shap_kernel(X_T, tabs, k)
            err = max(err, e)
            g = got.cpu().numpy().copy()
            g[:, :, -1] += base[None, :]
            exact = tshap.predict_contrib(use, Xn, k).reshape(n, k, -1)
            scale = row_scale(exact.reshape(n, -1))
            diff = np.abs(g - exact).reshape(n, -1)
            raw = _host_predict(Xn, use, k, False, 10, 10.0).reshape(n, k)
            add = np.abs(g.sum(axis=2) - raw)
            if not ((diff <= 1e-9 * scale).all() and (
                    add <= 1e-9 * np.maximum(np.abs(raw), 1.0)).all()):
                raise RuntimeError(f"TreeSHAP K = {k}, {n} rows: "
                                   f"{diff.max()} from the host walk, "
                                   f"additivity {add.max()}")
            plan = kts.shap_plan(n, T, kts.SMS, X_T.shape[0], L, D)
            same = {}
            if whole is None:
                whole = got
                for label, attr in (("one_group", "PARTIAL_BYTES"),
                                    ("no_dec_words", "DEC_BYTES"),
                                    ("device_acc", "ACC_BYTES")):
                    old = getattr(kts, attr)
                    setattr(kts, attr, 0)
                    try:
                        other = kts.tree_shap_cuda(X_T, tabs, k)
                    finally:
                        setattr(kts, attr, old)
                    same[label] = bool(torch.equal(other, whole))
                chunked = tshap.predict_contrib_device(
                    use, Xn, k, dev, depth,
                    chunk_bytes=4096 * 8 * (X.shape[1] + k * (X.shape[1]
                                                              + 1)))
                same["chunks_4096"] = chunked.tobytes() == (
                    g.reshape(n, -1) if k > 1 else g[:, 0]).tobytes()
            else:
                same["prefix_of_largest"] = bool(torch.equal(got,
                                                              whole[:n]))
            if not all(same.values()):
                raise RuntimeError(f"TreeSHAP K = {k}, {n} rows: bytes "
                                   f"differ across plans {same}")
            cases.append({"k": k, "rows": n, "plan": list(plan),
                          "max_abs_vs_plain": e,
                          "max_abs_vs_host": float(diff.max()),
                          "additivity_max_abs": float(add.max()),
                          "byte_identical": same})
    emit({"phase": "shap_adversarial", "trees": len(trees),
          "max_path_slots": 24, "cases": cases, "max_abs_err": err})
    return {"tree_shap": err}


# --------------------------------------------------------------------------
# SciPy sparse data: bin_csr, the Dataset surface, cv and reset_parameter
# --------------------------------------------------------------------------

def csr_entries(X, rs, explicit_zeros=0.0, dups=0.0, shuffled=0.0):
    """A SciPy CSR matrix of the dense rows X, stored adversarially from
    ``rs``: each zero stored explicitly (half of them as -0.0) with
    probability ``explicit_zeros``; before a ``dups`` share of the stored
    entries, an earlier entry of the same (row, column) with another value,
    and after another such share an explicit 0.0; the entries of a
    ``shuffled`` share of the rows in a random order.  Without ``dups`` its
    dense rows are X (``csr.toarray()``; NaN kept)."""
    import scipy.sparse as sp

    n, F = X.shape
    keep = (X != 0) | np.isnan(X) | (rs.rand(n, F) < explicit_zeros)
    rows, cols = np.nonzero(keep)
    vals = X[rows, cols].copy()
    zero = vals == 0
    vals[zero] = np.where(rs.rand(int(zero.sum())) < 0.5, 0.0, -0.0)
    # the order of the entries within a row: as stored by np.nonzero, or
    # at random in a shuffled row; a duplicate goes half a step before or
    # after its entry
    key = np.arange(len(rows), dtype=np.float64)
    mixed = (rs.rand(n) < shuffled)[rows]
    key[mixed] = rs.rand(int(mixed.sum())) * len(rows)
    parts = [(rows, cols, vals, key)]
    for shift, pick in ((-0.5, rs.rand(len(rows)) < dups),
                        (0.5, rs.rand(len(rows)) < dups / 2)):
        if not pick.any():
            continue
        other = (np.zeros(int(pick.sum())) if shift > 0
                 else np.round(rs.randn(int(pick.sum())) * 4.0, 1) + 0.5)
        parts.append((rows[pick], cols[pick], other, key[pick] + shift))
    r, c, v, k = (np.concatenate(p) for p in zip(*parts))
    order = np.lexsort((k, r))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return sp.csr_matrix((v[order], c[order].astype(np.int32), indptr),
                         shape=(n, F))


# (label, source, rows, features of the source, sentinel features,
# transpose, upload chunk bytes or None, duplicates, data dtype)
CSR_ADVERSARIAL = (
    ("adv_b16_rows", "adv", 250_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (),
     False, None, True, np.float64),
    ("adv_b16_transposed_chunks", "adv", 100_003,
     (0, 1, 2, 3, 4, 5, 6, 7, 8), (), True, 1 << 20, True, np.float64),
    ("adv_b8_rows_chunks", "adv", 200_003, (0, 1, 2, 4, 6, 7, 8), (), False,
     1 << 20, True, np.float64),
    ("adv_b8_float32", "adv", 50_001, (0, 1, 2, 4, 6, 7, 8), (), False, None,
     True, np.float32),
    ("predict_b16", "adv", 100_003, (0, 1, 2, 3, 4, 5, 6, 7, 8), (3, 4, 5),
     True, None, False, np.float64),
    ("predict_b8_chunks", "adv", 100_003, (0, 1, 2, 4, 6, 7, 8), (4,), True,
     1 << 20, False, np.float64),
    ("bundle_b8_rows", "bundle", 100_003, 1, (), False, None, True,
     np.float64),
    ("bundle_b16_rows_chunks", "bundle", 100_003, 2, (), False, 1 << 20,
     True, np.float64),
    ("bundle_b16_transposed", "bundle", 100_003, 2, (), True, None, True,
     np.float64),
    ("bundle_b8_int", "bundle", 20_001, 1, (), False, None, False, np.int64),
    ("empty_rows_and_column", "adv", 20_001, (0, 1, 2, 4, 6, 7, 8), (),
     False, None, True, np.float64),
    ("n1", "adv", 1, (0, 1, 2, 3, 4, 5, 6, 7, 8), (3,), True, None, False,
     np.float64),
    # one row of CSR_LONG_ROW entries (duplicates along it), several tiles'
    # worth; in chunks, that row is a chunk of its own
    ("long_row_b16_rows", "adv", 20_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (),
     False, None, True, np.float64),
    ("long_row_b8_transposed_chunks", "adv", 20_001, (0, 1, 2, 4, 6, 7, 8),
     (), True, 1 << 18, True, np.float64),
    # CSR_WIDE_COLUMNS columns, each alone in its group: bin_csr's wide
    # form (group ranges), both layouts
    ("wide_g_b16_rows", "wide", 10_001, (0, 1, 2, 3, 4, 5, 6, 7, 8), (),
     False, None, True, np.float64),
    ("wide_g_b8_transposed_chunks", "wide", 10_001, (0, 1, 2, 4, 6, 7, 8),
     (), True, 1 << 22, False, np.float64),
    # runs of empty rows (CSR_EMPTY_RUNS) longer than a tile: tile cuts
    # inside them
    ("tile_cuts_in_empty_runs_b8_rows_chunks", "adv", 60_001,
     (0, 1, 2, 4, 6, 7, 8), (), False, 1 << 20, True, np.float64),
    ("tile_cuts_in_empty_runs_b16_transposed", "adv", 60_001,
     (0, 1, 2, 3, 4, 5, 6, 7, 8), (), True, None, False, np.float64),
)
# the long row's entries (at least CSR_LONG_ROW_MIN when the rows are cut)
CSR_LONG_ROW = 40_000
CSR_LONG_ROW_MIN = 3_000
CSR_WIDE_COLUMNS = 600
# row ranges, as shares of the rows, that store no entry
CSR_EMPTY_RUNS = ((0.10, 0.30), (0.45, 0.46), (0.60, 0.95))


def with_long_row(csr, X, rs, length):
    """``csr`` with its middle row replaced by ``length`` entries of random
    columns (each column stored many times), values drawn from X's column
    (NaN, +-inf, -0.0 and bounds included) and explicit zeros."""
    import scipy.sparse as sp

    n, F = csr.shape
    k = n // 2
    cols = rs.randint(0, F, length)
    vals = X[rs.randint(0, n, length), cols]
    vals[rs.rand(length) < 0.05] = 0.0
    ip = csr.indptr.astype(np.int64)
    a, b = ip[k], ip[k + 1]
    indptr = ip.copy()
    indptr[k + 1:] += length - (b - a)
    return sp.csr_matrix((np.concatenate([csr.data[:a], vals, csr.data[b:]]),
                          np.concatenate([csr.indices[:a],
                                          cols.astype(np.int32),
                                          csr.indices[b:]]), indptr),
                         shape=(n, F))


def without_rows(csr, empty):
    """``csr`` with the entries of the rows marked in ``empty`` left out."""
    import scipy.sparse as sp

    n, F = csr.shape
    row_of = np.repeat(np.arange(n), np.diff(csr.indptr))
    keep = ~empty[row_of]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row_of[keep],
                                                        minlength=n))])
    return sp.csr_matrix((csr.data[keep], csr.indices[keep], indptr),
                         shape=(n, F))


def csr_adversarial_cases(seed, scale=1.0):
    """(label, CSR rows, dense rows or None, mappers, groups, sentinel
    features, transpose, chunk bytes) of ``CSR_ADVERSARIAL``: the rows of
    ``bin_adversarial_data`` (NaN, +-inf, -0.0, bounds +- one ulp,
    categories unseen, negative and past 2**63, an EFB bundle of
    overlapping features; 5000 categories make 16-bit bins) and of
    ``bin_bundle_data`` (Flight-Delay-shaped bundles, several features of
    a bundle non-default in a row; 16-bit), stored by ``csr_entries`` with
    explicit zeros and -0.0, unsorted rows and, where the case says so,
    duplicate (row, column) entries (then no dense rows); one case with
    empty rows and a column with no entry; one long row with duplicates
    along it (``with_long_row``); CSR_WIDE_COLUMNS columns of the
    adversarial features (rows drawn anew for each, nine in ten zero),
    each alone in its group; long runs of empty rows (``CSR_EMPTY_RUNS``);
    ``scale`` cuts the rows."""
    rs = np.random.RandomState(seed + 19)
    most = max(max(int(c[2] * scale), 1) for c in CSR_ADVERSARIAL)
    am, ag, AX = bin_adversarial_data(seed, most)
    bm, bg, BX = bin_bundle_data(seed, most)
    width = len(bg[1])
    for (label, source, n, feats, sentinel, transpose, chunk, dups,
         dtype) in CSR_ADVERSARIAL:
        n = max(int(n * scale), 1)
        if source == "adv":
            where = {f: j for j, f in enumerate(feats)}
            X = np.ascontiguousarray(AX[:n, list(feats)])
            ms = [am[f] for f in feats]
            gs = [g for g in ([where[f] for f in g if f in where]
                              for g in ag) if g]
            sentinel = [where[f] for f in sentinel]
        elif source == "wide":
            base = [feats[j % len(feats)] for j in range(CSR_WIDE_COLUMNS)]
            X = np.stack([AX[rs.randint(0, most, n), f] for f in base], 1)
            X[rs.rand(*X.shape) < 0.9] = 0.0
            ms = [am[f] for f in base]
            gs = [[j] for j in range(len(base))]
        else:
            k = 1 + feats * width
            X, ms, gs = np.ascontiguousarray(BX[:n, :k]), bm[:k], \
                bg[:1 + feats]
        if label.startswith("empty"):
            X[::7] = 0.0
            X[:, 2] = 0.0
        if dtype != np.float64:
            X = np.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
            X = np.clip(X, -1e30, 1e30).astype(dtype).astype(np.float64)
        if label.startswith("tile_cuts_in_empty_runs"):
            empty = np.zeros(n, bool)
            for a, b in CSR_EMPTY_RUNS:
                empty[int(a * n):int(b * n)] = True
            X[empty] = 0.0
        csr = csr_entries(X, rs, explicit_zeros=0.05,
                          dups=0.05 if dups else 0.0, shuffled=0.1)
        if label.startswith("tile_cuts_in_empty_runs"):
            csr = without_rows(csr, empty)
        if label.startswith("long_row"):
            csr = with_long_row(csr, X, rs, max(int(CSR_LONG_ROW * scale),
                                                CSR_LONG_ROW_MIN))
        csr.data = csr.data.astype(dtype)
        yield (label, csr, None if dups else X, ms, gs, list(sentinel),
               transpose, chunk)


class CsrCapture:
    """Records every ``bin_csr`` call (its chunk of CSR rows, tables, zero
    bins, output, first row, layout and launch plan) while active, by
    wrapping the dispatcher that ``bin_csr_matrix`` calls.  The calls still
    go through the kernel's wrapper and are counted there."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from lightgbm_torch.kernels import bin_csr as bc
        self._orig = orig = bc.bin_csr

        def call(indptr, indices, data, tables, zeros, out, row0=0,
                 transpose=False, plan=None):
            res = orig(indptr, indices, data, tables, zeros, out, row0,
                       transpose, plan)
            self.calls.append((indptr, indices, data, tables, zeros, out,
                               row0, transpose, plan))
            return res

        bc.bin_csr = call
        return self

    def __exit__(self, *exc):
        from lightgbm_torch.kernels import bin_csr as bc
        bc.bin_csr = self._orig


def replay_bin_csr(cap, host=None):
    """Every captured bin_csr launch through its plain version on the card
    (the same chunk and tables, a fresh output); raises unless the bins are
    equal byte for byte, and, where ``host`` bins ((N, G), or (G, N) for
    the transposed form) are given, unless the captured output of the last
    call equals them too.  Returns the launches replayed and the largest
    difference of bin values."""
    import torch
    from lightgbm_torch.kernels import bin_csr as bc
    from lightgbm_torch.kernels.layout import bin_values, bins_to_numpy

    outs = {}
    for indptr, indices, data, tables, zeros, out, row0, transpose, _ in \
            cap.calls:
        want = outs.setdefault(id(out), (out, torch.zeros_like(out)))[1]
        bc.bin_csr_plain(indptr, indices, data, tables, zeros, want, row0,
                         transpose)
    err = 0.0
    for out, want in outs.values():
        err = max(err, max_abs_diff(bin_values(out), bin_values(want)))
        if not torch.equal(out, want):
            raise RuntimeError(f"bin_csr differs from its plain version "
                               f"(max abs {err})")
    if host is not None:
        got = bins_to_numpy(cap.calls[-1][5])
        if got.dtype != host.dtype or not np.array_equal(got, host):
            raise RuntimeError(f"bin_csr differs from the host bins "
                               f"({got.dtype} {got.shape} against "
                               f"{host.dtype} {host.shape})")
    return len(cap.calls), err


def bin_csr_work(indptr, indices, tables, transpose=False):
    """Bytes and operations one bin_csr launch needs: the row pointers,
    each stored entry's column and value read once, each (row, group) bin
    written once; per entry a binary search (one compare a level, two more
    for the NaN test and the assembly)."""
    from lightgbm_torch.kernels import bin_rows as br
    n = indptr.shape[0] - 1
    nnz = indices.shape[0]
    n_bytes = 8 * (n + 1) + 12 * nnz + n * tables.num_groups * \
        tables.out_bytes
    per_col = np.zeros(tables.num_features, np.int64)
    for r in tables.host_feats:
        per_col[int(r[br.F_COLUMN])] = int(max(r[br.F_BOUNDS_LEN],
                                               r[br.F_CATS_LEN])
                                           ).bit_length() + 2
    counts = np.bincount(indices.cpu().numpy(),
                         minlength=tables.num_features)
    return n_bytes, int((counts * per_col).sum())


def csr_plan_stats(indptr, plan):
    """A bin_csr launch plan as the kernels line reports it: its fields,
    and its tiles' rows and entries (least, mean, most)."""
    fields, starts = plan
    ptr = indptr.cpu().numpy()
    st = starts.cpu().numpy().astype(np.int64)
    rows, ents = np.diff(st), np.diff(ptr[st])
    out = {"plan": list(fields)}
    for key, v in (("tile_rows", rows), ("tile_entries", ents)):
        out[key] = ([int(v.min()), float(v.mean()), int(v.max())]
                    if len(v) else [])
    return out


def time_bin_csr(call):
    """One captured bin_csr launch timed: the kernel under the call's plan
    (``device_ms``, into a scratch output, byte-equal to the call's), its
    plain version (CUDA events, one call) and its bound."""
    import torch
    from lightgbm_torch.kernels import bin_csr as bc

    indptr, indices, data, tables, zeros, out, row0, transpose, plan = call
    n = indptr.shape[0] - 1
    if plan is None:
        plan = bc.launch_plan(indptr.cpu().numpy(), tables, indices.device)
    scratch = torch.empty((tables.num_groups, n) if transpose
                          else (n, tables.num_groups), dtype=out.dtype,
                          device=out.device)
    bc.bin_csr_cuda(indptr, indices, data, tables, zeros, scratch, 0,
                    transpose, plan)
    rows = out[:, row0:row0 + n] if transpose else out[row0:row0 + n]
    if not torch.equal(scratch, rows):
        raise RuntimeError("bin_csr: the timed launch differs from the "
                           "captured one")
    ms = device_ms(lambda: bc.bin_csr_cuda(indptr, indices, data, tables,
                                           zeros, scratch, 0, transpose,
                                           plan), reps=10)
    plain = cuda_ms(lambda: bc.bin_csr_plain(indptr, indices, data, tables,
                                             zeros, scratch, 0, transpose),
                    reps=1, warmup=0)
    bnd = bound(*bin_csr_work(indptr, indices, tables, transpose))
    return {"rows": n, "entries": int(indices.shape[0]),
            "groups": tables.num_groups, "out_bytes": tables.out_bytes,
            "transpose": bool(transpose), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            **csr_plan_stats(indptr, plan)}


def check_bin_csr_adversarial(seed, scale=1.0):
    """bin_csr on ``csr_adversarial_cases``: every launch byte-equal to its
    plain version on the card, the output to the host
    (``construct_binned_sparse``; for the predict form ``bin_rows`` on the
    dense rows, launched on the card, and ``host_predict_bins``), both
    layouts and widths, in one upload or in chunks (launches at row0 > 0).
    Outside any main path's launch counts.  Returns the cases and the
    largest difference."""
    import torch
    from lightgbm_torch.binning import (construct_binned_sparse,
                                        device_group_order)
    from lightgbm_torch.kernels import bin_csr as bc
    from lightgbm_torch.kernels import bin_rows as br
    from lightgbm_torch.kernels.layout import bins_to_numpy

    dev = torch.device(CARD)
    cases, err = {}, 0.0
    for label, csr, X, ms, gs, sentinel, transpose, chunk in \
            csr_adversarial_cases(seed, scale):
        gs = device_group_order(gs, ms)
        tables = br.bin_tables(ms, gs, dev, sentinel=sentinel)
        with CsrCapture() as cap, np.errstate(invalid="ignore"):
            bc.bin_csr_matrix(csr, tables, transpose=transpose,
                              chunk_bytes=chunk or bc.CHUNK_BYTES)
        torch.cuda.synchronize()
        if sentinel:
            with np.errstate(invalid="ignore"):
                host = host_predict_bins(X, ms, gs, sentinel)
                dense = bins_to_numpy(br.bin_matrix(X, tables,
                                                    transpose=True)).T
            if not np.array_equal(dense, host):
                raise RuntimeError(f"{label}: bin_rows differs from the "
                                   "host")
        else:
            with np.errstate(invalid="ignore"):
                host = construct_binned_sparse(csr, ms, gs).bins
        launches, diff = replay_bin_csr(cap, host.T if transpose else host)
        err = max(err, diff)
        lens = np.diff(csr.indptr)
        plans = [(c[8][0], c[0].cpu().numpy(), c[8][1].cpu().numpy())
                 for c in cap.calls]
        cases[label] = {"rows": csr.shape[0], "entries": int(csr.nnz),
                        "longest_row": int(lens.max()),
                        "plans": [list(p) for p, _, _ in plans],
                        # tiles of more than twice the chunk's mean
                        # entries a tile (a row several tiles long)
                        "long_row_tiles": sum(
                            int((np.diff(ptr[s]) > 2 * max(
                                1, ptr[-1] // max(1, p.tiles))).sum())
                            for p, ptr, s in plans),
                        # cuts between two empty rows of the chunk
                        "cuts_in_empty_runs": sum(
                            int(((np.diff(ptr)[s[1:-1] - 1] == 0)
                                 & (np.diff(ptr)[s[1:-1]] == 0)).sum())
                            for _, ptr, s in plans),
                        "groups": len(gs), "sentinel": sentinel,
                        "transpose": transpose,
                        "out_bytes": tables.out_bytes,
                        "duplicates": X is None,
                        "data_dtype": str(csr.data.dtype),
                        "row0": [c[6] for c in cap.calls],
                        "launches": launches, "max_abs_err": diff}
    seen = {(c["transpose"], c["out_bytes"]) for c in cases.values()}
    wide = {c["transpose"] for c in cases.values()
            if any(p[1] > 1 for p in c["plans"])}
    if (len(seen) != 4 or not any(max(c["row0"]) > 0
                                  for c in cases.values())
            or wide != {False, True}
            or not any(c["long_row_tiles"] for c in cases.values())
            or not any(c["cuts_in_empty_runs"] for c in cases.values())):
        raise RuntimeError(f"bin_csr's cases missed a form: {sorted(seen)}, "
                           f"wide form in layouts {sorted(wide)}")
    return cases, err


SPARSE_SMALL_ONEHOT = (30, 300)


def make_sparse_small(n, seed):
    """About ``n`` rows of adversarial sparse data, canonical CSR (no
    duplicate entries): four numeric columns (NaN, +-inf, -0.0 stored,
    half the rows zero), a categorical column of 25 categories stored
    sparsely (category 0 implicit; NaN and negative values), a column of
    zeros, and one-hot blocks of ``SPARSE_SMALL_ONEHOT`` columns (one hot a
    row in 90 % of the rows; EFB bundles them, the second past 256 bins:
    16-bit), some rows empty; a label from the numeric columns and the hot
    columns.  Returns (CSR, dense rows, label, the categorical column)."""
    rs = np.random.RandomState(seed + 23)
    blocks = SPARSE_SMALL_ONEHOT
    F = 6 + sum(blocks)
    X = np.zeros((n, F))
    num = rs.randn(n, 4) * np.array([1.0, 3.0, 0.5, 10.0])
    num[rs.rand(n, 4) < 0.5] = 0.0
    num[rs.rand(n, 4) < 0.05] = np.nan
    num[rs.rand(n, 4) < 0.01] = np.inf
    num[rs.rand(n, 4) < 0.01] = -np.inf
    X[:, :4] = num
    cat = zipf_choice(rs, 25, 1.2, n).astype(np.float64)
    cat[rs.rand(n) < 0.05] = np.nan
    cat[rs.rand(n) < 0.03] = -2.0
    X[:, 4] = cat
    off, hot = 6, []
    for k in blocks:
        pick = zipf_choice(rs, k, 1.05, n)
        on = rs.rand(n) < 0.9
        X[np.arange(n)[on], off + pick[on]] = 1.0
        hot.append(np.where(on, pick, -1))
        off += k
    X[rs.rand(n) < 0.02] = 0.0
    logit = (np.nan_to_num(np.clip(X[:, 0], -3, 3)) - 0.5
             * np.nan_to_num(np.clip(X[:, 1], -9, 9)) / 3
             + np.isin(cat, [1, 3, 5]) + (hot[0] % 3 == 0)
             - 0.7 * (hot[1] % 4 == 1))
    y = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    csr = csr_entries(X, rs, explicit_zeros=0.02, shuffled=0.05)
    return csr, X, y, 4


def graph_runs(eng_runs):
    """A callback recording, after every iteration, the engine's graph
    runner and its captures, replays and eager runs (``eng_runs``: a list
    it appends (id, captures, replays, eager runs) to)."""
    def _callback(env):
        g = env.model.engine._graphs
        eng_runs.append((id(g), g.captures, g.replays, g.eager_runs))
    _callback.order = 50
    return _callback


def phase_train_sparse_small(seed, n=20_000, iters=5, num_leaves=63,
                             adversarial_scale=1.0):
    """SciPy sparse input on both devices: bin_csr on
    ``csr_adversarial_cases``; over ``make_sparse_small`` (CSR and CSC,
    zero_as_missing off and on): dyadic custom-gradient training from the
    CSR Dataset byte-identical on the CPU and the card and to the dense
    Dataset of the same rows; ``reset_parameter`` (a learning-rate list,
    num_leaves / lambda_l2 / min_data_in_leaf changed at iteration 3)
    fused (graphs captured, replayed, dropped and captured again) equal to
    eager on the card, and on dyadic gradients the card equal to the CPU;
    ``save_binary`` then ``Dataset(path)`` training to the same text;
    ``subset`` on the card equal to the parent's bins of those rows;
    ``cv`` over 3 folds and 5 rounds, each fold's model equal to ``train``
    on that fold's subset.  Every Dataset's and validation set's bin_csr
    launches replayed through the plain version."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.binning import construct_binned_sparse
    from lightgbm_torch.engine import _make_n_folds

    t_start = time.perf_counter()
    adv_cases, adv_err = check_bin_csr_adversarial(seed, adversarial_scale)
    csr, X, y, cat_col = make_sparse_small(n, seed)
    base = {"objective": "binary", "num_leaves": num_leaves,
            "max_splits_per_round": 16, "min_data_in_leaf": 5,
            "learning_rate": 0.5, "verbosity": -1}
    ds_kw = {"categorical_feature": [cat_col]}
    err = 0.0
    replays = 0

    def dataset(data, dev, extra, **kw):
        p = {**extra, "device_type": dev}
        return lt.Dataset(data, label=y, params=p, **ds_kw, **kw)

    def dyadic(data, dev, extra):
        p = {**base, **extra, "device_type": dev}
        bst = lt.Booster(p, dataset(data, dev, extra))
        for _ in range(iters):
            bst.update(fobj=dyadic_fobj)
        return model_trees_text(bst), bst

    texts = {}
    counts = {}
    for zam in (False, True):
        extra = {"zero_as_missing": zam}
        kernels.reset_launch_counts()
        with CsrCapture() as cap:
            card, bst = dyadic(csr, "cuda", extra)
        torch.cuda.synchronize()
        host = construct_binned_sparse(
            csr, bst.train_set.binned.bin_mappers,
            bst.train_set.binned.group_features).bins
        n_rep, diff = replay_bin_csr(cap, host)
        replays += n_rep
        err = max(err, diff)
        counts[f"zero_as_missing_{zam}"] = kernels.launch_counts()
        if kernels.launch_counts()["bin_csr"] == 0:
            raise RuntimeError("the CSR Dataset launched no bin_csr")
        widths = {int(b) for b in bst.train_set.binned.group_bin_counts}
        if max(widths) <= 256 or not any(len(g) > 1 and b <= 256 for g, b in
                                         zip(bst.train_set.binned
                                             .group_features,
                                             bst.train_set.binned
                                             .group_bin_counts)):
            raise RuntimeError(f"sparse small: group widths {widths} miss "
                               "an 8- or 16-bit bundle")
        cpu, _ = dyadic(csr, "cpu", extra)
        dense, _ = dyadic(X, "cuda", extra)
        csc, _ = dyadic(csr.tocsc(), "cuda", extra)
        if not (card == cpu == dense == csc):
            raise RuntimeError(f"sparse small (zero_as_missing={zam}): "
                               "CSR card, CSR CPU, dense and CSC texts "
                               "differ")
        texts[zam] = card

    # reset_parameter at iteration 3: the learning rate every iteration and
    # the tree shape once
    n_reset = iters + 1
    lrs = [0.5, 0.25, 0.125, 0.5, 0.25, 0.125][:n_reset]

    def shape(i):
        return 15 if i < 3 else 31

    def resets():
        return [lt.reset_parameter(
            learning_rate=lrs, num_leaves=shape,
            lambda_l2=lambda i: 0.0 if i < 3 else 2.0,
            min_data_in_leaf=lambda i: 5 if i < 3 else 40)]

    reset_texts, runs = {}, {}
    ds_reset = dataset(csr, "cuda", {})
    for fused in ("auto", "off"):
        log = []
        bst = lt.train({**base, "fused_iter": fused}, ds_reset, n_reset,
                       callbacks=resets() + [graph_runs(log)])
        reset_texts[fused] = model_trees_text(bst)
        runs[fused] = log
    if reset_texts["auto"] != reset_texts["off"]:
        raise RuntimeError("reset_parameter: fused and eager differ")
    runners = {}
    for gid, cap_n, rep_n, eager_n in runs["auto"]:
        runners[gid] = (cap_n, rep_n, eager_n)
    if len(runners) != 2 or any(c == 0 or r == 0
                                for c, r, _ in runners.values()):
        raise RuntimeError(f"reset_parameter: graph runners {runners}: "
                           "expected two, each capturing and replaying")
    reset_dyadic = {}
    for dev in ("cuda", "cpu"):
        p = {**base, "device_type": dev}
        bst = lt.Booster(p, dataset(csr, dev, {}))
        for i in range(n_reset):
            bst.reset_parameter({"learning_rate": lrs[i],
                                 "num_leaves": shape(i)})
            bst.update(fobj=dyadic_fobj)
        reset_dyadic[dev] = model_trees_text(bst)
    if reset_dyadic["cuda"] != reset_dyadic["cpu"]:
        raise RuntimeError("reset_parameter on dyadic gradients: the card "
                           "and the CPU differ")

    # save_binary -> Dataset(path) -> train
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "sparse.bin")
        ds_bin = dataset(csr, "cuda", {})
        ds_bin.save_binary(path)
        loaded = lt.Dataset(path, params={"device_type": "cuda"})
        t_orig = model_trees_text(lt.train(base, ds_bin, iters))
        t_load = model_trees_text(lt.train(base, loaded, iters))
    if t_orig != t_load:
        raise RuntimeError("a save_binary file trains another model")

    # subset: the parent's bins of those rows
    parent = dataset(csr, "cuda", {}).construct()
    idx = np.sort(np.random.RandomState(seed).choice(n, n // 3,
                                                     replace=False))
    kernels.reset_launch_counts()
    with CsrCapture() as cap:
        sub = parent.subset(idx).construct()
    torch.cuda.synchronize()
    n_rep, diff = replay_bin_csr(cap, parent.binned.bins[idx])
    replays += n_rep
    err = max(err, diff)
    if not np.array_equal(sub.binned.bins, parent.binned.bins[idx]):
        raise RuntimeError("subset's bins differ from the parent's rows")

    # cv: 3 folds x 5 rounds, each fold's model as train on its subset
    t0 = time.perf_counter()
    res = lt.cv(base, dataset(csr, "cuda", {}), iters, nfold=3,
                return_cvbooster=True)
    cv_s = time.perf_counter() - t0
    folds = _make_n_folds(parent, None, 3, base, 0, True, True)
    for b, (tr, _) in zip(res["cvbooster"].boosters, folds):
        solo = lt.train(base, dataset(csr, "cuda", {}).construct()
                        .subset(tr), iters)
        if model_trees_text(b) != model_trees_text(solo):
            raise RuntimeError("a cv fold's model differs from train on "
                               "its subset")
    emit({"phase": "train_sparse_small", "rows": n,
          "features": int(csr.shape[1]), "entries": int(csr.nnz),
          "bin_csr_adversarial": adv_cases,
          "dyadic_text_identical": {"cpu_card_dense_csc": True,
                                    "zero_as_missing": [False, True]},
          "launches": counts,
          "reset_parameter": {"fused_equals_eager": True,
                              "card_equals_cpu_dyadic": True,
                              "graph_runners": list(runners.values())},
          "save_binary_same_text": True, "subset_equals_parent_rows": True,
          "cv": {"folds": 3, "rounds": iters, "seconds": cv_s,
                 "fold_text_equals_train": True,
                 "valid_logloss_mean": res["valid binary_logloss-mean"]},
          "bin_csr_replayed": replays,
          "max_abs_err": max(err, adv_err),
          "seconds": time.perf_counter() - t_start})
    return {"bin_csr": max(err, adv_err)}


def allstate_levels(columns=30, features=4228, big=(700, 520, 380, 300)):
    """The level counts of the Allstate-shaped generator's categorical
    source columns: ``big`` (past 255 levels), then geometrically spaced
    counts from 2 up, the last adjusted so that all sum to ``features``."""
    small = np.round(np.geomspace(2, 190, columns - len(big))).astype(int)
    small[-1] += features - sum(big) - int(small.sum())
    return list(big) + [int(k) for k in small]


def make_allstate_like(n, seed, features=4228, columns=30):
    """Rows shaped after the Allstate insurance-claim data of LightGBM's
    experiments (docs/Experiments.rst: 13 184 290 rows, 4 228 one-hot
    features, binary, AUC): ``columns`` categorical source columns with
    ``allstate_levels`` levels (4 228 in all, four past 255), each level
    drawn Zipf-like (exponent 1.1) and left out (no level) in 5 % of the
    rows, one-hot into a canonical 0/1 CSR matrix of about 28.5 entries a
    row; the label a seeded logistic model of the active levels.  Returns
    (CSR, label, the logistic model's scores)."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed + 31)
    levels = allstate_levels(columns, features)
    offsets = np.concatenate([[0], np.cumsum(levels)])
    cols = np.empty((n, columns), np.int64)
    on = rs.rand(n, columns) >= 0.05
    for j, k in enumerate(levels):
        p = 1.0 / np.arange(1, k + 1) ** 1.1
        cols[:, j] = offsets[j] + np.searchsorted(np.cumsum(p / p.sum()),
                                                  rs.rand(n))
    cols = np.minimum(cols, offsets[1:] - 1)
    w = rs.randn(features) * 0.45
    score = np.where(on, w[cols], 0.0).sum(axis=1) - 0.3
    y = (rs.rand(n) < 1 / (1 + np.exp(-score))).astype(np.float64)
    counts = on.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = cols[on].astype(np.int32)
    csr = sp.csr_matrix((np.ones(len(indices)), indices, indptr),
                        shape=(n, features))
    return csr, y, score


def phase_train_sparse(seed, smi, rows=1_000_000, held_out=250_000, iters=20,
                       cv_folds=3, cv_rounds=5, chunk_rows=100_000,
                       host_rows=20_000):
    """The Allstate-shaped cell (``make_allstate_like``): ``rows`` trained
    from a CSR Dataset (mappers and EFB on the host, bins by bin_csr on the
    card, the kernel counts read around it), ``held_out`` rows as a
    ``create_valid`` validation set with AUC; binary, 255 leaves, learning
    rate 0.1, split budget 64, ``iters`` iterations fused beside an eager
    arm (byte-identical text); held-out AUC > 0.70 beside the generator's
    own scores'; ``predict`` on the held-out CSR with the counts read
    around it (one bin_csr predict launch, K1's 16-bit form, no host walk),
    within rtol 1e-4 / atol 1e-5 of the host walk on ``host_rows``;
    ``predict_s`` of those rows on the old path (dense slabs on the host
    walk) and through bin_csr and K1; ``construct_s``
    split into mappers, EFB and the card fill, the host
    ``construct_binned_sparse`` beside it; bin_csr on a ``chunk_rows``-row
    chunk equal to its plain version, timed beside its bound and the plain
    version; ``cv`` over ``cv_folds`` stratified folds, ``cv_rounds``
    rounds, early stopping after 3, fused beside eager.  Returns the
    kernels line's bin_csr entry and the largest difference."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import basic as tbasic
    from lightgbm_torch import kernels
    from lightgbm_torch.binning import construct_binned_sparse
    from lightgbm_torch.kernels import bin_csr as bc
    from lightgbm_torch.kernels import bin_rows as br
    from lightgbm_torch.utils.timer import host_reads

    t0 = time.perf_counter()
    X, y, score = make_allstate_like(rows + held_out, seed)
    Xh, yh, sh = X[rows:], y[rows:], score[rows:]
    X, y = X[:rows], y[:rows]
    data_s = time.perf_counter() - t0
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_splits_per_round": 64, "metric": "auc", "verbosity": -1}
    kernels.reset_launch_counts()
    with CsrCapture() as ds_cap:
        t0 = time.perf_counter()
        ds = lt.Dataset(X, label=y).construct()
        construct_s = time.perf_counter() - t0
        valid = ds.create_valid(Xh, label=yh).construct()
    torch.cuda.synchronize()
    construct_launches = kernels.launch_counts()["bin_csr"]
    b = ds.binned
    group_bins = [int(v) for v in b.group_bin_counts]
    if max(group_bins) <= 256:
        raise RuntimeError("the Allstate-shaped Dataset has no 16-bit group")
    t0 = time.perf_counter()
    host = construct_binned_sparse(X, b.bin_mappers, b.group_features).bins
    host_fill_s = time.perf_counter() - t0
    if not np.array_equal(b.bins, host):
        raise RuntimeError("the card's CSR bins differ from the host's")
    n_rep, err = replay_bin_csr(ds_cap)
    del host

    def run(extra):
        kernels.reset_launch_counts()
        r0 = host_reads()
        with TimedIters() as timed:
            t1 = time.perf_counter()
            bst = lt.train({**params, **extra}, ds, iters,
                           valid_sets=[valid], valid_names=["held_out"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
        return (bst, timed, train_s, kernels.launch_counts(),
                host_reads() - r0)

    bst, timed, train_s, launches, reads = run({})
    fused = fused_and_eager(bst, timed, launches, reads,
                            lambda extra, n_iter: lt.train(
                                {**params, **extra}, ds, n_iter), iters)
    valid_auc = bst.best_score["held_out"]["auc"]

    # held-out predict: bin_csr's predict form and K1's 16-bit form
    walks = []
    real_walk = tbasic._host_predict

    def counted_walk(*a, **kw):
        walks.append(a[0].shape[0])
        return real_walk(*a, **kw)

    tbasic._host_predict = counted_walk
    try:
        kernels.reset_launch_counts()
        with CsrCapture() as p_cap:
            t0 = time.perf_counter()
            raw = bst.predict(Xh, raw_score=True)
            predict_s = time.perf_counter() - t0
        p_launches = kernels.launch_counts()
        p_wide = kernels.wide_launch_counts()
    finally:
        tbasic._host_predict = real_walk
    if (walks or p_launches["bin_csr"] != 1
            or p_launches["predict_stream"] != 1
            or p_wide["predict_stream"] != 1):
        raise RuntimeError(f"sparse predict: host walks {walks}, launches "
                           f"{p_launches}, 16-bit {p_wide}")
    p_rep, p_err = replay_bin_csr(p_cap)
    err = max(err, p_err)
    held_auc = auc(yh, raw)
    gen_auc = auc(yh, sh)
    if held_auc <= 0.70:
        raise RuntimeError(f"Allstate-shaped held-out AUC {held_auc}")
    # predict_s before (dense slabs on the host walk) and after, on the
    # same rows; the host walk is the scores' reference
    sub = Xh[:host_rows]
    min_rows = lt.Booster._DEVICE_PREDICT_MIN_ROWS
    lt.Booster._DEVICE_PREDICT_MIN_ROWS = 10 ** 12
    try:
        t0 = time.perf_counter()
        old = bst.predict(sub, raw_score=True)
        before_s = time.perf_counter() - t0
    finally:
        lt.Booster._DEVICE_PREDICT_MIN_ROWS = min_rows
    t0 = time.perf_counter()
    new = bst.predict(sub, raw_score=True)
    after_s = time.perf_counter() - t0
    if not (np.allclose(new, old, rtol=RTOL, atol=ATOL)
            and np.allclose(raw[:host_rows], old, rtol=RTOL, atol=ATOL)):
        raise RuntimeError("sparse predict differs from the host walk")

    # bin_csr alone on one chunk of the Dataset's rows
    tables = br.bin_tables(b.bin_mappers, b.group_features, ds.device)
    zeros = torch.from_numpy(bc.zero_bins(tables)).to(ds.device)
    part = X[:chunk_rows]
    ptr = torch.from_numpy(np.asarray(part.indptr, np.int64)).to(CARD)
    ind = torch.from_numpy(part.indices.astype(np.int32)).to(CARD)
    val = torch.from_numpy(part.data.astype(np.float64)).to(CARD)
    out = torch.empty((chunk_rows, tables.num_groups),
                      dtype=br.storage_dtype(tables.out_bytes), device=CARD)
    call = (ptr, ind, val, tables, zeros, out, 0, False,
            bc.launch_plan(part.indptr, tables, ptr.device))
    bc.bin_csr_cuda(*call)
    want_bins = torch.zeros_like(out)
    bc.bin_csr_plain(ptr, ind, val, tables, zeros, want_bins)
    if not torch.equal(out, want_bins):
        raise RuntimeError("bin_csr differs from its plain version on the "
                           "Allstate-shaped chunk")
    chunk_time = time_bin_csr(call)
    # its predict form: the held-out predict's launch
    predict_time = time_bin_csr(p_cap.calls[0])
    stages = {}
    bc.bin_csr_matrix(X, tables, times=stages)

    # cv: stratified folds, early stopping on the fold mean, fused and eager
    cv_out = {}
    for fused_iter in ("auto", "off"):
        t0 = time.perf_counter()
        res = lt.cv({**params, "fused_iter": fused_iter,
                     "early_stopping_round": 3}, ds,
                    cv_rounds, nfold=cv_folds, stratified=True,
                    return_cvbooster=True)
        torch.cuda.synchronize()
        cvb = res.pop("cvbooster")
        cv_out[fused_iter] = {
            "seconds": time.perf_counter() - t0,
            "best_iteration": cvb.best_iteration,
            "auc_mean": res["valid auc-mean"],
            "fold_auc": [dict((m, v) for _, m, v, _ in b.eval_valid())["auc"]
                         for b in cvb.boosters],
            "texts": [model_trees_text(b) for b in cvb.boosters]}
    if cv_out["auto"]["texts"] != cv_out["off"]["texts"]:
        raise RuntimeError("cv: fused and eager folds differ")
    for v in cv_out.values():
        del v["texts"]
    emit({"phase": "train_sparse", "card": smi, "rows": rows,
          "held_out_rows": held_out, "features": int(X.shape[1]),
          "entries_per_row": X.nnz / rows,
          "source_levels": allstate_levels(), "data_s": data_s,
          "groups": len(group_bins), "group_bins": group_bins,
          "groups_past_256_bins": sum(v > 256 for v in group_bins),
          "construct_s": construct_s,
          "construct_split_s": dict(ds.construct_times),
          "host_construct_binned_sparse_s": host_fill_s,
          "fill_stages_s": stages, "construct_launches": construct_launches,
          "construct_launches_replayed": n_rep,
          "iterations": iters, "train_s": train_s,
          "s_per_tree": statistics.median(timed.seconds[1:]),
          "launches": launches, "fused_iter": fused,
          "held_out_auc": held_auc, "valid_auc": valid_auc,
          "generator_auc": gen_auc,
          "predict_s": predict_s, "predict_launches": p_launches,
          "predict_wide_launches": p_wide, "predict_host_walks": 0,
          "predict_launches_replayed": p_rep,
          "predict_before_after": {"rows": host_rows,
                                   "host_slabs_s": before_s,
                                   "bin_csr_k1_s": after_s},
          "bin_csr_chunk": chunk_time, "bin_csr_predict": predict_time,
          "cv": cv_out, "max_abs_err": err})
    return {"name": "bin_csr", "route": "cuda",
            "source": "lightgbm_torch/kernels/csrc/bin_csr.cu",
            "replaces": KERNEL_REPLACES["bin_csr"],
            "launches": construct_launches + p_launches["bin_csr"],
            "max_abs_err": err, "ms": chunk_time["ms"],
            "plain_ms": chunk_time["plain_ms"],
            "bound_ms": chunk_time["bound_ms"],
            "bound_by": chunk_time["bound_by"], "library_ms": None,
            "cell": "train_sparse", "rows": chunk_time["rows"],
            "entries": chunk_time["entries"], "plan": chunk_time["plan"],
            "tile_rows": chunk_time["tile_rows"],
            "tile_entries": chunk_time["tile_entries"],
            "predict": {k: predict_time[k] for k in (
                "rows", "entries", "groups", "out_bytes", "ms", "plain_ms",
                "bound_ms", "bound_by", "plan", "tile_rows",
                "tile_entries")}}, {"bin_csr": err}


def ptxas_lines(build, names):
    """The register and spill lines of each named kernel's build log."""
    return {n: [ln.strip() for ln in
                (build.BUILD_DIR / f"{n}.log").read_text().splitlines()
                if "registers" in ln or "spill" in ln] for n in names}


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=500)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--train-iters", type=int, default=20)
    ap.add_argument("--sampled-iters", type=int, default=40)
    ap.add_argument("--backend-iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 2
    import lightgbm_torch
    from lightgbm_torch.kernels import build

    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "package": lightgbm_torch.__version__})
    t0 = time.perf_counter()
    # tree_shap, the longest build, compiles while the first phases run;
    # its first launch (phase predict_surface_small) waits for it
    shap_build = build.build(["tree_shap"], wait=False)
    built = build.build([n for n in build.SOURCES if n != "tree_shap"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": built, "ptxas": ptxas_lines(build, built)})
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        phase_small(args.seed, tmp)
        small_err = phase_train_small(args.seed)
        sampled_small_err = phase_train_sampled_small(args.seed)
        quant_small_err = phase_train_quantized_small(args.seed)
        k1, binner, ds, Xs, ys, full_bst = phase_full(
            args.seed, args.rows, args.trees, args.leaves, tmp, smi)
        (k2, k4), k3_refit = phase_train(ds, Xs, ys, args.train_iters, smi)
        t0 = time.perf_counter()
        shap_built = shap_build()
        emit({"phase": "build_tree_shap", "waited_s": time.perf_counter() - t0,
              "per_kernel_s": shap_built,
              "ptxas": ptxas_lines(build, shap_built)})
        surface_small_err = phase_predict_surface_small(args.seed)
        k1["leaf"], shap_line = phase_predict_surface(
            smi, full_bst, ds, Xs, iters=args.train_iters)
        del full_bst
        k3, sampled_err = phase_train_sampled(ds, Xs, ys, smi,
                                              args.sampled_iters)
        # K3's second caller: the refit of phase train's model
        k3["refit"] = k3_refit
        k567, backends_err = phase_train_backends(
            args.seed, args.rows, ds, Xs, ys, smi, args.backend_iters)
        k2i, quant_err = phase_train_quantized(ds, Xs, ys, smi,
                                               args.train_iters)
        reg_small_err = phase_train_regression_small(args.seed)
        reg_lines, reg_err = phase_train_regression(
            args.seed, smi, ds, Xs, args.train_iters)
        del ds, Xs, ys
        mc_small_err = phase_train_multiclass_small(args.seed)
        k2k_k8, mc_err = phase_train_multiclass(args.seed, smi)
        cat_small_err = phase_train_categorical_small(args.seed)
        wide_small_err = phase_train_wide_small(args.seed)
        cat_lines, cat_err = phase_train_categorical(
            args.seed, smi, args.rows, args.rows // 4, args.train_iters)
        wide_lines, wide_err = phase_train_wide(args.seed, smi)
        rank_small_err = phase_train_ranking_small(args.seed)
        rank_lines, rank_err = phase_train_ranking(args.seed, smi)
        sparse_small_err = phase_train_sparse_small(args.seed)
        csr_line, sparse_err = phase_train_sparse(args.seed, smi)
        adv_err = phase_hist_adversarial(args.seed)
        k1_adv_err = phase_predict_adversarial(args.seed)
        bin_adv_err = phase_bin_adversarial(args.seed)
        shap_adv_err = phase_shap_adversarial(args.seed)
    kernel_lines = [k1, k2, k3, k4] + k567 + k2k_k8 + [k2i, binner,
                                                       shap_line, csr_line]
    errs = (small_err, sampled_small_err, quant_small_err, sampled_err,
            backends_err, quant_err, mc_small_err, mc_err, cat_small_err,
            cat_err, wide_small_err, wide_err, rank_small_err, rank_err,
            reg_small_err, reg_err, adv_err, k1_adv_err, bin_adv_err,
            surface_small_err, shap_adv_err, sparse_small_err, sparse_err)
    for k in kernel_lines:
        if k["name"] in cat_lines:
            k["categorical"] = cat_lines[k["name"]]
        if k["name"] in rank_lines:
            # its launches, replays and times on the ranking cell
            r = rank_lines[k["name"]]
            r["max_abs_err"] = max(e.get(k["name"], 0.0)
                                   for e in (rank_small_err, rank_err))
            k["ranking"] = r
        if k["name"] in reg_lines:
            # its launches, replays and times on the regression cell
            r = reg_lines[k["name"]]
            r["max_abs_err"] = max(e.get(k["name"], 0.0)
                                   for e in (reg_small_err, reg_err))
            k["regression"] = r
        # K2's int form has one row for both its class counts
        names = ((k["name"], k["name"] + "_k")
                 if k["name"] == "route_and_hist_int" else (k["name"],))
        k["max_abs_err"] = max([k["max_abs_err"]]
                               + [e.get(n, 0.0) for e in errs for n in names])
        if k["name"] in wide_lines:
            # the 16-bit form: its launches on the Flight Delay cell, its
            # replays there and on the small rows, its adversarial cases
            w = wide_lines[k["name"]]
            w["max_abs_err"] = max(
                [w["max_abs_err"]]
                + [e.get(n, 0.0) for e in (wide_small_err, wide_err)
                   for n in names]
                + [e.get(k["name"] + "_wide", 0.0)
                   for e in (adv_err, k1_adv_err)])
            k["wide"] = w
    emit({"phase": "seconds", "per_phase_s": phase_seconds()})
    emit({"kernels": kernel_lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
