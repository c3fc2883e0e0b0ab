#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases, each printed on a line of its own:

1. device   - the card (nvidia-smi name and power limit), torch and CUDA.
2. build    - nvcc builds every kernel of the main path from csrc/, and
              c++ the image loaders' host libraries (the tar index and the
              baseline JPEG decoder).
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the main path's shapes and at ragged ones, with its
              error, tolerance and times: ``ms``, single calls between
              CUDA events (host work in the wrapper included), and
              ``device_ms``, a CUDA graph of its launches replayed between
              two events, per launch. The chain kernel's ``device_ms``
              rotates over twelve 4096-image microbatches (600 MB, well
              past the 50 MB L2), as the pipeline's stream of microbatches
              finds its inputs cold; ``planned_call_ms`` is the wall clock
              per microbatch of its planned path over the same inputs.
              Its ``short_rows`` times the short-row design (a warp a
              row, several rows a step) on 440-float rows against the
              block-a-row design on the same arrays seen as rows of ten.
              Its ``at_path_shapes`` holds and times it at the chains the
              fusion pass tags in the SIFT-Fisher pipelines: VOC's
              PixelScaler >> GrayScaler on 48x48 images and on 500x333
              real ones (rows cut into 333 segments, once more with the
              gray stage masked and 5 rows zeroed), and the
              Fisher-vector tail on VOC's and ImageNet's encodings,
              each with its own bound.
4. slice    - RandomPatchCifar at full width (256 filters) on 50,000
              synthetic training and 10,000 test images, as the JAX
              package's bench times its headline; test accuracy must
              reach 0.72, and the fused conv+rectify+pool kernel must
              have run once per microbatch.
5. linear_pixels - LinearPixels on the same images: the elementwise chain
              kernel once per 4096-image microbatch, test accuracy within
              0.005 of the JAX package's 0.7919 on these arrays. Then the
              same stages again, each executor's optimizer run and
              structural check timed (``workflow_host_split``), and the
              fused apply head over the training rows in 2048-row
              microbatches against one batch.
6. kernel_cifar  - RandomPatchCifarKernel on the same images (256
              filters, gamma 2e-3, lambda 10, 2048-row blocks, one
              epoch): the RBF block kernel in every block step of the fit
              and every train block of the apply; test accuracy >= 0.72.
              ``krr_fit_split`` sets the RBF kernel's device time over
              the fit's launches against the stage's seconds.
7. cross    - the same 2048 images through the fused kernel and through
              an fp32 conv followed by the rectify+pool+vectorize stage,
              which runs the rectify+pool kernel through
              rectify_pool_vectorize; that stage is also held against its
              plain version.
8. fused    - RandomPatchCifar's run_fused on the same images after a
              warm call: one stream of launches, timed on the train +
              test basis, its stages on the stream's clock beside
              run_staged's, and the synchronizing calls it makes beside
              the staged pipeline's (torch's sync debug mode, each call
              named by its source line); test accuracy >= 0.72 and within
              0.005 of the slice's, whose filters it shares.
9. random_cifar - RandomCifar (numpy Gaussian filters, no whitener) on the
              same images: one fused conv kernel launch per microbatch,
              test accuracy >= 0.72 and within 0.005 of the JAX
              package's on these arrays.
10. augmented - RandomPatchCifarAugmented: 200,000 random 24x24 training
              crops, the fused conv kernel at pool 12 stride 11, BCD, five
              views a test image averaged; test accuracy >= 0.72 and
              within 0.01 of the JAX package's (its filter draws differ).
11. augmented_kernel - RandomPatchCifarAugmentedKernel: the crops flipped
              and shuffled, kernel ridge regression at gamma 2e-4 over
              98 blocks of 2048 rows (the RBF block at 200,000 x 2048 x
              512), ten views a test image; test accuracy >= 0.72, and
              the RBF products at least the fit's and the test apply's
              blocks.

12. timit   - TimitPipeline at full width (440-dimensional frames, 4096
              Gaussian cosines at gamma 0.0555, 2048-column blocks, three
              BCD epochs, lambda 1e-3) on 200,000 synthetic training and
              50,000 test frames of 12 classes, after a warm call; then
              the same stages one at a time (featurize, each BCD epoch,
              predict and evaluation); test accuracy within 0.005 of the
              JAX package's on these arrays.
13. mnist    - MnistRandomFFT at MNIST's width: 784-dimensional rows, 10
              classes, 60,000 train and 10,000 test rows (the TIMIT
              stand-in at that shape: no MNIST file is in the repository),
              four FFT branches (2048 features), block 2048, lambda 1e-4,
              after a warm call; 1,000 rows written to a label-first CSV
              and read back equal; test accuracy within 0.005 of the JAX
              package's; no chain kernel planned and no kernel launched.
14. solvers  - on the timit phase's training features (200,000 x 4096,
              the -1/+1 class indicators, lambda 1e-3): the exact normal
              equations, BCD (2048, three epochs) and dense L-BFGS (20
              steps, memory 10), each after a warm call, with its objective
              against the exact one and its train accuracy; L-BFGS's loss
              history, line-search evaluations and synchronizing calls;
              and the dual-form solve on the first 2,048 rows against the
              primal ridge (float64) on the same rows.
15. voc      - VOCSIFTFisher at the reference's widths: dense SIFT (step 6,
              2 scales), PCA to 80, a 256-component GMM (k-means++ start,
              30 EM steps), 40,960-wide Fisher vectors, class-weighted BCD
              (block 4096, one pass, lambda 0.5, mixture weight 0.5) over
              20 classes, on 5,011 training and 4,952 test synthetic 48x48
              images (VOC 2007's trainval and test counts), after a warm
              call on 500 of each; then the same run one stage at a time
              (SIFT, PCA fit, GMM fit, Fisher encode, BWLS fit, predict and
              mAP) and once more under torch's sync debug mode. mAP within
              0.01 of the JAX package's on these arrays; the fitted PCA,
              GMM and (W, b) carried to the CPU score the first 256 test
              images within 1e-3 of max|score| of the card's, with the same
              argmax; the chain kernel once per fused microbatch of its
              two tagged chains, train and test, and once for the
              optimizer's sample of three images; no other kernel. Its
              ``pca``: the route the PCA node's cost models chose
              (``pca_route``), both costs under the card's weights, and
              the route the JAX package's formulas give under its
              analytic CPU weights, which must be the same.
16. imagenet - ImageNetSiftLcsFV at the JAX configuration's widths (SIFT
              and LCS branches, PCA 32, 8 components, 1,024 features, 10
              classes) on 5,000 training and 2,000 test synthetic images,
              after a warm call on 500 of each; test accuracy within 0.01
              of the JAX package's on these arrays; the chain kernel
              once per fused microbatch of each branch's Fisher-vector
              tail, train and test; no other kernel; ``pca`` as VOC's,
              for both branches.
17. newsgroups - NewsgroupsPipeline at the reference's widths: n-grams of
              orders 1-2, square-root TF, 100,000 common features, naive
              Bayes (lambda 1) over 20 classes, on 11,314 training and
              7,532 test synthetic documents (20 Newsgroups' "bydate"
              counts), after a warm call on 500 of each; the strings are
              featurized on the host and the CSR goes to the card once.
              Then the same run one stage at a time (featurize, vocabulary
              fit, vectorize, copy, fit, predict, evaluate) and the CSR
              products between events. Test accuracy within 0.005 of the
              JAX package's; the card's vocabulary and model carried to
              the CPU score the first 256 test documents within 1e-5 of
              max|score| of the card's, with the same argmax; the
              synchronizing calls named; no kernel launched.
18. amazon   - AmazonReviewsPipeline: 20,000 synthetic reviews split
              80/20, the same featurizer at 100,000 features, logistic
              regression (lambda 1e-3, 50 L-BFGS steps) on the CSR on the
              card; its objective within 1e-3 of the JAX package's,
              accuracy within 0.005; a fit's line-search evaluations and
              synchronizing calls; staged as Newsgroups; no kernel
              launched.
19. stupid_backoff - StupidBackoffPipeline over 11,314 synthetic
              documents: host code in both packages; vocabulary, trigram
              count and mean log score equal to the JAX package's.
20. workflow - RandomPatchCifar at the slice's width and data through the
              workflow layer: the default optimizer's batches one at a
              time (host seconds, node count after each); `Pipeline.fit`
              (the fit's seconds beside run_staged's total; the
              conv+rectify+pool kernel once per training microbatch: CSE
              shares the training featurization of the scaler's fit, the
              solver's fit and the train predict); the fitted form (the
              featurizer, the Cacher, one fused scaler, linear map and
              argmax); `save` (bytes) and `FittedPipeline.load` on the
              card (seconds); the loaded pipeline on the 10,000 test
              images (seconds, images/s, the kernel once per test
              microbatch), its predictions equal bit for bit to the
              in-memory pipeline's and its accuracy within 0.002 of the
              slice's; the synchronizing calls of the fit and of the
              apply; and one `AutoCachingOptimizer` plan's cache points.
              The fitted form is one megafused chain (the featurizer, the
              scaler, the linear map and the argmax; the Cacher
              absorbed). No chain kernel: none of the fitted form's runs
              lowers.
21. least_squares - the cost-model solver choice. The cost weights
              measured on the card (the probes' seconds a step, the
              rates they imply beside the H100's published peaks, and
              whether the committed cuda_calibration.json applied), the
              measurement written to smoke_out/cuda_calibration.json;
              LeastSquaresEstimator on TIMIT's 200,000 x 4096 cosine
              features (12 classes, lambda 1e-3): every candidate's
              estimate, the choice, its fit seconds and its objective
              against the exact solve's; on Amazon's training CSR
              (16,000 x 100,000, the -1/+1 indicators of two classes,
              lambda 1e-3): the choice (sparse L-BFGS), its route, fit
              seconds, the float64 objective against the JAX package's
              on the CPU, and the SparseLinearMapper's test error on
              the test CSR; SparseLBFGSwithL2 forced to each route on a
              seeded CSR of 200,000 x 16,384 at density 0.004 (the
              reference suite's shape, n cut from 5,000,000 for time):
              seconds, objectives, the routes' W difference, the route
              the automatic rule takes and its estimate for each; and
              the same CSR as a PaddedSparseDataset (bytes) on the
              sparse-product route. No kernel.
22. hog_daisy - HogExtractor and DaisyExtractor on 4,096 seeded 48x48 gray
              images (the VOC stand-in's size): seconds, and the first 64
              held against the port's CPU path. No kernel.
23. runtime - the workflow runtime at full width. RandomPatchCifar fit,
              saved and loaded with megafusion on and off: the plan's
              labels (one Megafused[...]), the first apply of the 10,000
              test images after a warm-up (turned on for it; 0
              captures, 1 replay, K1 5 launches), a second apply (1 replay, 0 captures), the
              apply's seconds on and off in alternating pairs (on, off,
              off, on), its synchronizing calls, predictions equal to the
              unmegafused apply's and scores within 1e-5 of max|score|;
              LinearPixels' head over the 50,000 training rows as one
              replay against 25 microbatches of 2048, and each dispatch
              knob's cost on a whole run; VOC's featurization (5,011
              images) with megafusion off (the gray chain chunk by chunk)
              and on (the default: a bucket's chunks as one group) and
              the overlap engine off and on (off, on, on, off): equal
              descriptors, seconds, the pinned bytes at most
              (2·depth + 2) chunks, or depth + 1 groups; and VOC's
              train and test featurization as two branches of one graph
              under the concurrent scheduler at 4 workers and at 1
              (4, 1, 1, 4): equal outputs, seconds. Warm-up failures: 0;
              the loaded apply 0 synchronizing calls (the live plane on);
              three calls of one chain at one rung compile 0, 1 (its
              capture), 0.
24. loaders - the image loaders on the card's machine: the committed
              voc_mini.tar, imagenet_mini.tar and 000012.jpg decoded onto
              the card by the port's baseline decoder (the machine has no
              libjpeg); names and labels equal to the JAX package's, and
              each image's pixel sum and digest equal to those pinned from
              the JAX package's native (libjpeg) decode. A tar of 1,000
              copies of 000012.jpg (VOC 2007's 5,011 training images cut
              to 1,000: their float32 decode would take 10 GB) with a
              labels CSV (class i mod 20): `voc_loader`'s seconds,
              images/s, decode threads and bytes; VOCSIFTFisher at the
              reference's widths (PCA 80, GMM 256, 40,960 features) through
              `run` from that tar (train = test): seconds, peak memory,
              K4 launches, synchronizing calls, its mAP printed, not held
              (the images are copies); and VOCSIFTFisher and
              ImageNetSiftLcsFV from the mini tars at small widths, their
              card scores against the port's CPU path on the card's
              fitted weights within 1e-3 of max|score|.
25. telemetry - RandomPatchCifar at full size (fit and test apply) under
              `trace_run` with a ledger path: the trace loads, has spans
              of categories pipeline, phase, node, chunk and step with
              parent ids, its node self-times sum to no more than the
              run's wall clock, and the traced and untraced runs make the
              same synchronizing calls, K1 launches (30) and
              ``dispatch.programs_executed``; traced against untraced
              seconds in 3 alternating pairs for RandomPatchCifar and
              LinearPixels; a fitted LinearPixels applied with megafusion
              on, then off, each with a ledger: `diff_runs` names the
              ``KEYSTONE_MEGAFUSION`` flip; the compile accounting after
              the initial build and at the end, and the runtime phase's
              one capture; a flight-recorder dump: a valid Chrome trace
              within its capacity; 200 requests of 64 images to a fitted
              LinearPixels with the live plane off and on (off, on, on,
              off) and `health()`'s p50 and p99 per padded shape.
26. serving - the KP9xx certifier and `ServingRuntime` on the card: the
              seven `analyzable()` examples certified with the card's
              calibration (each verdict, its KP9xx findings and its
              certified bounds at 1 and 64 rows, held to
              `SERVING_CARD_VERDICTS`, which the CPU tests pin too);
              RandomPatchCifar at full width (256 filters, fit on the
              50,000 images, its scores saved and loaded onto the card)
              served from envelope max_batch 64 (ladder 1, 2, 4 ... 64):
              2,000 single test images from 8 client threads, each answer
              within 1e-4 of max|score| of the batch apply's and the same
              class, no dispatch off the ladder, after `start()` no graph
              capture, no cold compile record and no launch-plan build,
              every dispatch one replay and K1's launches a whole number
              of them, no watchdog breach; requests/s, p50/p99 a request,
              the coalesced batches, synchronizing calls a dispatch, and
              each rung's observed p50/p99 a dispatch (20 straight
              dispatches at each rung, and at 3 and 11 rows) beside its
              certified bound; a hot swap mid-traffic to a fit on other
              labels (no request lost, every answer one version's, the
              new version's captures on the swapping thread, none on the
              dispatcher's; an answer from neither version is printed
              with its row, errors, time against the swap's window and
              the rows whose answer it equals under either version), and
              with ``--swap-repeats K`` K more, each to a fresh load of
              the other version, each round's dispatches printed; the
              kill switch (64 requests under 8 threads,
              each the per-row apply bit for bit); a burst of 32 into a
              queue of depth 4 (sheds counted and flight-dumped, the
              answered ones right); LinearPixels' classes served through
              K4 replays (500 requests); Newsgroups through `TextIngress`
              and `split_fitted_at` (host tokens at ingress, the naive
              Bayes tail on the card, classes equal to the direct apply);
              `TenantRegistry` admitting the RandomPatchCifar runtime at
              its priced peak and refusing it one byte under.
27. planners - RandomPatchCifar (256 filters, BCD 4096) and LinearPixels
              on the slice's 50,000/10,000 images through `Pipeline.fit`
              and the test apply with the planners on (the default),
              with the precision planner alone (the unified planner off,
              so its bf16 trail in front of K1 is enforced) and off: each
              arm's ledger decisions by kind, planned chunk, precision
              trails, K1 and K4 launches, test score, seconds and peak
              memory; `plan_unified` (sequential and joint seconds,
              changed kinds) and `plan_stage_precision` (trails, saved
              bytes) called directly on each path's fused graph, where
              the rules would swallow a failure; K1 on the bf16
              PixelScaler output of 2,048 test images against its plain
              version; VOCSIFTFisher's planned chunk and peak (from the
              voc phase). Held: scores within 0.005 of the planner-off
              arm and RandomPatchCifar's in ACC_BAND, K4's launches equal
              in every arm, the direct calls answered (a trail for
              RandomPatchCifar's featurizer, as JAX prices one), K1 on
              bf16 within 2e-2.
28. out_of_core - RandomPatchCifar at full width trained from 500,000
              CIFAR-shaped images (6.1 GB as float32) drawn 8,192 at a
              time from seed + i on the slice's class templates
              (`synthetic_cifar_out_of_core`), tested on 10,000 drawn the
              same way; the filters learned once from a sample of the
              source (each shard drawn once); trained under
              hbm_budget_bytes = 2 GiB and without a budget. Each run's
              seconds, score, planned chunk and windows, decisions, host
              caches, the spill.* counters, the reload stall against the
              planner's reload seconds, and peak memory beside the
              budget. Held: the budgeted plan holds a host `CacheMarker`
              and a ``spill`` record whose alternatives include an
              infeasible device cache; K1 once a microbatch of every
              window and of the test images in both runs; the score in
              ACC_BAND; 99% of the budgeted run's predictions equal to
              the unbudgeted run's.
29. measurement - the measurement tier on the card. ``dispatch``:
              `dispatch_bench.dispatch_count_report` over its four
              examples under its six plans: fit-run and apply-run
              programs, K1 and K4 launches, graph replays and
              synchronizing calls ([fit, apply] each); held: the outputs
              of every plan equal serial_unfused's within 1e-5,
              precision's in its band, the ledger's megafusion records
              predicting the one-program applies, K1 and K4 in every
              fused plan. ``compile``: `compile_bench.compile_count_report`:
              cold and warm library builds and graph captures and both
              runs' seconds, the host chunks' captures padded and ragged,
              and an example rebuilt twice and applied three times a
              build (captures a build); held: the warm runs build nothing
              and capture no more than the cold ones, padded < ragged.
              ``reconcile``: RandomPatchCifar (256 filters, BCD 4096) fit
              and applied on the slice's images under a trace with a
              ledger (K1 30), LinearPixels likewise (its ``chain_kernel``
              spans), and one RandomPatchCifar apply alone in a trace
              with a fresh registry: `reconcile_trace`'s worst static
              against observed bytes, `reconcile_roofline`'s predicted and
              observed seconds per stage and the kernel rows, the
              decisions' run-level join (held: predicted programs_executed
              equal to observed on the one-apply trace), and
              `cost_model_drift`'s implied weights against the card's
              calibration; ``python -m keystone_tpu_torch.telemetry
              --ledger <trace> --emit-calibration <file>`` in a
              subprocess, RandomPatchCifar's serving ladder certified on
              the card's weights and with ``KEYSTONE_COST_CALIBRATION``
              at the file (held: the file's weights resolve), and 500
              requests from 8 threads to a fitted RandomPatchCifar
              runtime under a trace, each rung's dispatch p50/p99 joined
              to both bounds by `reconcile_serving`. ``contracts``:
              `audit_registry`'s findings per rule (held: none),
              `validate(level="full")` on the bound full-width
              RandomPatchCifar (held: no error, no KP5xx) and ``python -m
              keystone_tpu_torch.analysis --explain-roofline
              RandomPatchCifar`` in a subprocess (held: exit 0).
30. nlp     - the POS and NER taggers: `POSTagger.trained_crf` and
              `NER.trained_crf` on the card, each the linear-chain CRF at
              the JAX package's defaults (4,000 generated sentences, seed
              0, 2^15 hashed buckets, 12 features a token, L-BFGS up to
              60 steps by JAX's stopping rule; POS 15 tags and 491,760
              weights), tagging the next 500 sentences: fit seconds with
              the host's hashing apart, steps, evaluations, the
              synchronizing calls of a second fit, decode tokens/s
              (batched, warm) beside the host structured perceptron's
              (600 sentences, 3 epochs), peak memory. Held: accuracy
              above 0.97 and within 0.005 of the JAX package's CPU
              accuracy, the final NLL at most 1e-3 above JAX's, POS at
              least the perceptron's accuracy, NER's BIO rule (an I-X
              only after I-X or B-X), the card's weights decoded on the
              CPU path to the same tags, the objective and its gradient
              at the card's weights in float64 on the card and on the
              CPU within 1e-5 (value) and 1e-6 of max|gradient| (the
              float32 figures printed beside);
              `CoreNLPFeatureExtractor` over the card's NER on 16
              held-out sentences equal to the CPU path's n-grams; no
              kernel launched.
31. parallel - the data axis (`keystone_tpu_torch/parallel/`): a
              one-process RandomPatchCifar (256 filters, BCD 4096) staged
              and `run_fused` on the slice's arrays, then an NCCL group of
              world size 1 (`init_multihost` on a free localhost port,
              a timeout) and the same arrays placed on
              `global_data_mesh()`: the pipeline staged and `run_fused`
              on the mesh. Held: predictions equal to the one-process
              run's on every test row (a difference is reported with its
              count of rows), accuracies equal, `run_fused`'s W and b
              equal bit for bit, K1 30 launches in each run and on the
              mesh's rows against its plain version at K1_TOL; the
              collectives by kind (calls, bytes, seconds on the stream,
              share of `train_seconds`); a `format="dcp"` save and load
              of the fitted pipeline (seconds, bytes) predicting alike;
              the ``p0`` dispatch counter. The group is destroyed after.
32. model_axis - the model axis and the static side of multi-GPU: the
              static tier (`analysis/sharding.py`, `plan_sharding`) on
              RandomPatchCifar's fit and test graphs at 50,000/10,000 and
              on `dispatch_bench`'s four examples, on layouts 2x4, 8x1
              and 1x2 (no KP6xx on the examples; the planner's choices
              and bytes equal to `MODEL_AXIS_PINNED`, the CPU's), the
              analysis CLI's ``--explain-sharding --plan --mesh-shape
              2x4 --json`` in this process; then two ranks of this
              script (``--model-axis-rank``) on the one card, a gloo
              group over its tensors on the (1, 2) mesh: RandomPatchCifar
              at 256 filters staged and `run_fused`, the features each
              rank's column tile and BCD gathering its block over
              ``model``. Held: K1 30 launches a run on each rank and on
              the rank's rows against its plain version at K1_TOL; test
              accuracy within 0.005 of 0.831; at most 0.1% of the test
              predictions different from phase 31's one-process run;
              `run_fused`'s W within 2e-3 of one process's; W, b and the
              predictions equal on both ranks; a collective over the
              model axis in each run. Printed: the collectives by kind
              and axis (calls, bytes; the seconds of a synchronizing
              trace, which under gloo pass through host memory and are
              no NVLink figure) and each rank's peak memory beside
              `per_device_pass`'s prediction.
33. data_axis - the image estimators on the data axis: two ranks of this
              script (``--data-axis-rank``) on the one card, a gloo group
              over its tensors on the (2, 1) mesh, after a warm run at a
              tenth of the counts. RandomPatchCifarKernel at full width
              (50,000/10,000, 256 filters, 2048-row blocks: K5 on each
              rank's rows, each block's rows gathered), the augmented
              pair (200,000 crops drawn once in global order and placed
              on the ranks; K1 at 24x24 on each rank's crops),
              VOCSIFTFisher at the reference's widths (5,011/4,952;
              SIFT, the gray chain and the Fisher-vector tail on each
              rank's images, the PCA and GMM on one process's sample,
              BWLS's sums and Grams all-reduced) and ImageNetSiftLcsFV
              (5,000/2,000), each fitted stage by stage as phases 6, 10,
              11, 15 and 16 fit it, and held to them: KRR's alpha within
              1e-5 of max|alpha| (RandomPatchCifarKernel) or 5e-5 (the
              augmented kernel: 98 blocks carry the rounding of each
              rank's KA update), BCD's W within 1e-3 of max|W| (5e-3
              fitted whole), at most 10 of 10,000 kernel test
              predictions different and 10 moved in each augmented test
              confusion, at most 2 of 2,000 ImageNet test predictions
              different, accuracies within 0.005, VOC's mAP within 1e-3;
              VOC's PCA components within 1.5e-3, GMM means 1e-2, W
              3.5e-2 and scores 7e-3 (TSQR moves the PCA, the GMM
              carries it). Each rank also refits its solver on the
              gathered rows in one process (KRR, and BCD fitted stage
              by stage), so the split's own share of the model's
              difference is printed. BWLS alone: VOC from
              sideband CSVs of phase 15's PCA and GMM, in this process
              and on the ranks, W and scores within 1e-4. The CIFAR
              entry points as a user calls them
              (`run_random_patch_cifar_kernel`,
              `run_random_patch_cifar_augmented{,_kernel}` with
              ``mesh=``, each fitted whole) against the same calls in
              this process, at the same limits. K5 launched on each
              rank in the KRR fit and apply, K1 in the CIFAR runs, K4 on
              each rank in VOC and ImageNet; both ranks' results equal.
              Printed per rank and run: K1, K4 and K5 launches, the
              collectives by kind (calls, bytes; seconds of a
              synchronizing trace, through host memory), the precision
              planners' storage trails (beside the one-process run's),
              the PCA routes, peak memory and seconds.
34. text_axis - the text side of the data axis: two ranks of this script
              (``--text-axis-rank``) on the one card, a gloo group over
              its tensors on the (2, 1) mesh, after a warm run on 500
              documents. NewsgroupsPipeline (11,314/7,532 documents,
              100,000 features, 20 classes) and AmazonReviewsPipeline
              (20,000 reviews, 80/20, 50 L-BFGS steps) through
              ``run_newsgroups(..., mesh=)`` and ``run_amazon(...,
              mesh=)``, every rank passing every document and keeping
              its share: the vocabularies merged over the ranks, naive
              Bayes' counts and logistic regression's loss and gradient
              all-reduced; `SparseLBFGSwithL2` on Amazon's training CSR
              (λ and steps of phase 21, its iterative route on each
              rank's rows); StupidBackoffPipeline on 11,314 documents;
              `GaussianKernelGenerator` anchored at 4,096 seeded
              2,048-wide rows a rank (every rank's rows collected),
              applied to 25,000 rows a rank (K5 on the rank's rows
              against the 8,192 anchors); ZCA, the approximate PCA, the
              dual least squares and LDA at the sizes of their JAX
              tests. Newsgroups and Amazon run once untraced (their
              seconds), then traced. Held to this run's one-process
              phases 17, 18, 19
              and 21 (`TEXT_AXIS_REF`): the vocabularies equal, naive
              Bayes' log-priors equal and log-conditionals within 1e-6 of
              their largest, the Newsgroups test predictions and
              accuracy equal; Amazon's float64 objective within 1e-3,
              at most 4 of 4,000 test predictions moved, accuracy and F1
              equal; the sparse fit's last objective within 1e-5 and W
              within 1e-3 of max|W|; the backoff scores within 1e-9. In
              each rank, against one process's fit of the whole rows:
              K5's output (and against `rbf_block_reference`) within
              K5_TOL, the dense fits within 1e-6. Every rank's arrays
              equal. Printed per rank and run: seconds, K5 launches, the
              collectives over ``data`` by kind (calls, bytes, seconds of
              a synchronizing trace: gloo through host memory, not
              NVLink) and peak memory.

Each path's launch counts are set to 0 just before it runs and read just
after. The process-wide prefix table (`PipelineEnv`) is reset before each
phase's timed run, so no phase reuses an earlier run's fits or cached
datasets, and its peak memory holds only its own run. The RBF kernel
counts its products (``rbf_block.launches``) and its split prepasses
(``rbf_split.launches``, two a product) apart.

Then a ``total`` line (the script's seconds from its start, the
build included), a ``kernels`` JSON line, the card line, and as the last
line
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero; with no card it exits non-zero before any phase.
"""

from __future__ import annotations

import collections
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor-core
# rates, fp32 CUDA-core rate, HBM3 bandwidth
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

# the main path's shapes: one 2048-image microbatch, the headline data
HEADLINE_N = 2048
N_TRAIN, N_TEST = 50_000, 10_000
# one LinearPixels microbatch
CHAIN_N = 4096
# rows of 440 floats (the TIMIT frames of the JAX bench's KRR geometry)
# that time the chain kernel's short-row design: 72 MB an input
SHORT_ROWS_N, SHORT_ROW_FLOATS = 40_960, 440
# (m, n, d, gamma) of the RBF block: a fit block of RandomPatchCifarKernel
# (50,000 rows against 2048 of them, 2048 features), then the JAX bench's
# KRR flagship geometry (bench.py:359-361, 678-706)
# the augmented kernel pipeline's blocks (four 24x24 crops of each
# training image, 512 features, gamma 2e-4)
N_AUG_TRAIN = 4 * N_TRAIN
RBF_GEOMETRIES = ((N_TRAIN, 2048, 2048, 2e-3), (98_304, 4096, 440, 0.01),
                  (N_AUG_TRAIN, 2048, 512, 2e-4))
# the geometries timed beside their checks: the fit block and the
# augmented fit block
RBF_TIMED = ((N_TRAIN, 2048, 2048), (N_AUG_TRAIN, 2048, 512))
# (n, side, filters, normalize, pool, stride, timed) of the fused conv
# kernel: the headline microbatch, ragged and narrow banks, and a
# microbatch of the augmented pipelines' 24x24 crops (pool 12 stride 11:
# one window an axis)
CONV_CHECKS = ((HEADLINE_N, 32, 256, True, 14, 13, True),
               (37, 32, 256, True, 14, 13, False),
               (64, 32, 16, True, 14, 13, False),
               (128, 32, 256, False, 14, 13, False),
               (HEADLINE_N, 24, 256, True, 12, 11, True),
               (37, 24, 256, True, 12, 11, False))

# bf16 operands: max error over max |plain|, the limit the JAX package's
# tests hold its Pallas kernel to (tests/test_pallas_ops.py:162-164)
K1_TOL = 2e-2
K2_TOL = 1e-5   # fp32 sums in another order: max error over max |plain|
# the elementwise chain: only the reductions' order differs; max error
# over max |plain|, the JAX interpret test's limit
# (tests/test_chain_kernels.py:128)
K4_TOL = 1e-6
#: rows of the segmented K4 check whose masked stage zeroes them
K4_MASKED_ROWS = 5
# the RBF block: max abs error on outputs in (0, 1], and the same below 1
# on the diagonal, where x2 + y2 - 2xy cancels. At a fit block's width
# one TF32 product misses by about 6e-3 there; the kernel's three
# (3xTF32) by about 4e-6 in their CPU emulation
# (tests/test_torch_rbf_split.py)
K5_TOL = 5e-5

# the JAX package's test accuracies on these arrays (CPU runs)
LINEAR_PIXELS_JAX_ACC = 0.7919
KERNEL_CIFAR_JAX_ACC = 0.8199
# RandomCifar's and RandomPatchCifarAugmented's (full width, 256 filters)
RANDOM_CIFAR_JAX_ACC = 0.7314
AUGMENTED_JAX_ACC = 0.8012
# RandomPatchCifarKernel's test accuracy on the card with the fp32 RBF
# kernel it had before the 3xTF32 one (NVIDIA H100 80GB HBM3, 700 W)
KERNEL_CIFAR_FP32_ACC = 0.8227

# TIMIT's depth, cut from 2,251,569 training frames to keep the script's
# time; the test set is a quarter of it, as the pipeline makes it
TIMIT_N_SYNTH = 200_000
# MNIST's published shape
MNIST_N_TRAIN, MNIST_N_TEST, MNIST_DIM, MNIST_CLASSES = 60_000, 10_000, 784, 10
MNIST_CSV_ROWS = 1_000
# the JAX package's test accuracies on these arrays (CPU runs; the
# synthetic frames separate their classes)
TIMIT_JAX_ACC = 1.0
MNIST_JAX_ACC = 1.0
# ½‖XW + b − Y‖² + ½λ‖W‖² on the timit features after the JAX package's
# fits on the CPU: DenseLBFGSwithL2's 20 steps, and BCD's three epochs.
# The port on the CPU came within 3.9e-7 (L-BFGS) and 1.1e-8 (BCD) of
# them; the tolerances leave room for the card's other sums, the
# iterative L-BFGS more. Three epochs of BCD over two correlated
# 2048-column blocks stay far above the exact minimum (0.66 above it,
# 0.665 in float64 at 50,000 rows), so BCD is held to JAX's objective
# and to the exact one as a floor
LBFGS_JAX_OBJECTIVE = 3255.0658926011715
LBFGS_OBJECTIVE_RTOL = 1e-3
BCD_JAX_OBJECTIVE = 5402.08106084742
BCD_OBJECTIVE_RTOL = 1e-4
# the dual solve against the float64 primal, relative
DUAL_PRIMAL_RTOL = 1e-3
# the zoom line search accepts a step that raises the objective by up to
# this share of its value (optax's approx_dec_rtol)
LBFGS_APPROX_DECREASE = 1e-6

# the analytic weights the JAX package resolves on the CPU
# (keystone_tpu/nodes/learning/cost_model.py:40-42): PCA's route by JAX's
# formulas, printed beside the port's choice under the card's weights
JAX_CPU_WEIGHTS = (5e-15, 1.25e-12, 1e-11)

# VOC 2007's trainval and test counts, the generator's 48x48 images (cut
# from VOC's ~500x375); the reference's widths (PCA 80, 256 components)
VOC_N_TRAIN, VOC_N_TEST, VOC_CLASSES = 5011, 4952, 20
VOC_PCA_DIMS, VOC_GMM_K = 80, 256
IMAGENET_N_TRAIN, IMAGENET_N_TEST = 5000, 2000
# images of each set in the warm call before a timed run
SIFT_FISHER_WARM = 500
# the JAX package's CPU mAP and test accuracy on these arrays (the
# synthetic classes separate fully, so the scores are also held to the
# port's CPU path on the card's fitted weights)
VOC_JAX_MAP = 1.0
IMAGENET_JAX_ACC = 1.0
# test images the port's CPU path scores with the card's fitted weights,
# and the share of max|score| their scores may differ by (SIFT entries
# that quantize 1 apart; tests/test_torch_sift_fisher.py measures 1.4e-4
# between the packages on the CPU)
VOC_CPU_CHECK = 256
VOC_CPU_SCORE_RTOL = 1e-3

# 20 Newsgroups "bydate": 11,314 training and 7,532 test posts (the corpus
# is not in the repository: the JAX package's synthetic_corpus at those
# counts fills the reference's 100,000 common features); Amazon: 20,000
# synthetic reviews, split 80/20 (the reference corpus is far larger);
# stupid backoff over 11,314 synthetic documents
NEWS_N_TRAIN, NEWS_N_TEST, NEWS_CLASSES = 11_314, 7_532, 20
TEXT_FEATURES = 100_000
AMAZON_N, AMAZON_LAM = 20_000, 1e-3
BACKOFF_N = 11_314
# documents of each set in the warm call before a timed run
TEXT_WARM = 500
# the JAX package's CPU values at these sizes, from
# `python tests/test_torch_text_pipelines.py` (jax_reference_values): the
# Newsgroups test accuracy; Amazon's objective, evaluated in float64 from
# the training CSR at JAX's fitted W, its test accuracy and F1; the
# stupid-backoff results. The synthetic classes separate fully, so the
# accuracies are weak checks: the objective and the scores are held too
NEWS_JAX_ACC = 1.0
AMAZON_JAX_OBJECTIVE = 0.008395272325415535
AMAZON_OBJECTIVE_RTOL = 1e-3
AMAZON_JAX_ACC, AMAZON_JAX_F1 = 1.0, 1.0
BACKOFF_JAX = {"vocab": 400, "num_trigrams": 652_275,
               "mean_log_score": -7.824418656112373}
BACKOFF_TOL = 1e-9
# test documents the port's CPU path scores with the card's fitted
# vocabulary and naive Bayes model, and the share of max|score| their
# scores may differ by (float32 sums over a row's ~100 nonzeros in
# another order; tests/test_torch_classifiers.py holds the packages to
# 1e-6 on the CPU)
NEWS_CPU_CHECK = 256
NEWS_CPU_SCORE_RTOL = 1e-5


# the calibration probes: a 4096-square fp32 GEMM (137 GFLOP a step) and a
# 256 MB read-and-write pass, each chained 10 and 20 steps; where the
# measurement is written
CAL_GEMM_DIM, CAL_MEM_MB, CAL_ITERS = 4096, 256, 10
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")
# the least-squares choice: the objective of the chosen solver may lie
# below the exact one by float32 rounding only
LSQ_EXACT_FLOOR = -1e-6
AMAZON_LSQ_LAM = 1e-3
# the JAX package's LeastSquaresEstimator on Amazon's training CSR on the
# CPU (`python tests/test_torch_sparse_solvers.py`): sparse L-BFGS by
# sparse products (20 steps), its float64 objective and the test error
# rate. The port on the CPU lands 1.4e-4 below that objective (float32
# sums in another order over 100,000 features)
AMAZON_LSQ_JAX_OBJECTIVE = 0.040898551132522276
AMAZON_LSQ_JAX_TEST_ERROR = 0.0
AMAZON_LSQ_RTOL = 1e-3
# the reference suite's sparse shape (LeastSquaresEstimatorSuite: d =
# 16,384 at density 0.004, k = 2), n cut from 5,000,000 to 200,000
SPARSE_N, SPARSE_D, SPARSE_K, SPARSE_DENSITY = 200_000, 16_384, 2, 0.004
SPARSE_LAM, SPARSE_ITERS = 1.0, 20
# the two routes' W, as a share of max|W|; the padded rows against the CSR
SPARSE_ROUTES_RTOL = 1e-3
PADDED_RTOL = 1e-5
# HOG and DAISY on the card against the CPU path, a share of max|value|
DESC_N, DESC_SIDE, DESC_CPU_CHECK, DESC_RTOL = 4096, 48, 64, 1e-4

# phase 24: the committed archives and what the JAX package's native
# (libjpeg) decode gives for them, here as each image's uint8 pixel sum
# and the first 16 hex digits of the SHA-256 of its uint8 bytes
RES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "resources")
VOC_MINI, VOC_MINI_CSV = "voc_mini.tar", "voc_mini_labels.csv"
IMAGENET_MINI, JPEG_12 = "imagenet_mini.tar", "000012.jpg"
DECODE_PINS = {
    "voc_mini.tar": [
        ("JPEGImages/000001.jpg", (64, 64, 3), 1260417, "015903b0cba0fc2f"),
        ("JPEGImages/000002.jpg", (64, 64, 3), 845029, "fa0d0cf9663ef1bf"),
        ("JPEGImages/000003.jpg", (64, 64, 3), 740533, "80571a7935e2710c"),
        ("JPEGImages/000009.jpg", (64, 64, 3), 1110866, "d894f418a03dd348")],
    "imagenet_mini.tar": [
        ("n01234567/im_a.jpg", (64, 64, 3), 1260417, "015903b0cba0fc2f"),
        ("n01234567/im_b.jpg", (64, 64, 3), 1109824, "c83c52a7e051bc72"),
        ("n07654321/im_c.jpg", (64, 64, 3), 1110866, "d894f418a03dd348"),
        ("n07654321/im_d.jpg", (64, 64, 3), 845029, "fa0d0cf9663ef1bf"),
        ("n99999999/im_e.jpg", (64, 64, 3), 996532, "74106fc3dcec8dc3")],
    "000012.jpg": [
        ("000012.jpg", (333, 500, 3), 42230637, "403f6b399a8bf220")],
}
# the JAX package's loaders on the mini tars: (file, labels) of
# `voc_loader`, (name, label) of `imagenet_loader` with this labels map
VOC_MINI_ROWS = [("000001.jpg", [3, 11]), ("000002.jpg", [0]),
                 ("000003.jpg", [19])]
IMAGENET_MINI_LABELS = {"n01234567": 0, "n07654321": 1}
IMAGENET_MINI_ROWS = [0, 0, 1, 1]
# the 1,000-image tar (VOC 2007's 5,011 training images cut to 1,000)
BIG_TAR_N = 1000
# 000012.jpg's (and a VOC 2007 image's usual) height and width: K4's
# segmented path at the kernels phase
VOC_REAL_H, VOC_REAL_W = DECODE_PINS[JPEG_12][0][1][:2]
MINI_PCA_DIMS, MINI_GMM_K = 8, 4
# phase 25
TRACE_PAIRS = 3
REQUESTS, REQUEST_ROWS = 200, 64

# the serving phase (26): single-image requests from the test set, client
# threads, the envelope's largest batch (the ladder 1, 2, 4 ... 64); the
# kill switch's, the burst's and LinearPixels' requests; Newsgroups'
# synthetic training documents and requests; seconds of traffic on each
# side of the hot swap; served scores against the batch apply, relative
# to the largest score
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_MAX_BATCH = 2000, 8, 64
SERVE_KILL_REQUESTS, SERVE_SHED_DEPTH, SERVE_SHED_BURST = 64, 4, 32
SERVE_LP_REQUESTS, SERVE_NEWS_DOCS, SERVE_NEWS_REQUESTS = 500, 2000, 64
SERVE_SWAP_SECONDS = 0.5
#: hot swaps after the first, each to a fresh load of the other version
#: (``--swap-repeats K``; 0 when the script runs with no arguments)
SWAP_REPEATS = 0
SERVE_RUNG_REPS = 20
SERVE_SCORE_RTOL = 1e-4
#: each example's certificate under the card's calibration: (certified,
#: its KP9xx [rule, severity] pairs); tests/test_torch_serving.py pins the
#: same table on the CPU with the calibration's rates
SERVING_CARD_VERDICTS = {
    "MnistRandomFFT": (True, [["KP902", "INFO"], ["KP903", "INFO"]]),
    "RandomPatchCifar": (True, [["KP902", "INFO"], ["KP903", "INFO"]]),
    "LinearPixels": (True, [["KP902", "INFO"], ["KP903", "INFO"]]),
    "TimitPipeline": (True, [["KP902", "INFO"], ["KP903", "INFO"]]),
    "NewsgroupsPipeline": (False, [["KP901", "ERROR"]]),
    "VOCSIFTFisher": (True, [["KP902", "WARNING"], ["KP903", "INFO"]]),
    "ImageNetSiftLcsFV": (True, [["KP902", "WARNING"], ["KP903", "INFO"]]),
}


# phases 27-28: the plan tier and the out-of-core tier. ACC_BAND is the
# slice's accuracy floor (and 1); a planner-on run stays within
# PLANNER_ACC_GAP of its planner-off twin, the slice's own 0.005
ACC_BAND = (0.72, 1.0)
PLANNER_ACC_GAP = 0.005
OOC_N = 500_000           # CIFAR-shaped training images, drawn a shard
OOC_SHARD = 8192          # at a time from seed + i
OOC_TEST = 10_000
OOC_BUDGET = 2 << 30      # hbm_budget_bytes of the budgeted run
OOC_AGREE = 0.99          # predictions equal to the unbudgeted run's
OOC_TEST_SEED = 1 << 20   # the test images' seed, past every shard's
MEASURE_REQUESTS = 500    # phase 29's traced serving run
MEASURE_REPO = os.path.dirname(os.path.abspath(__file__))
# the nlp phase (30): the CRF at the JAX package's defaults (crf_tagger:
# 4,000 generated sentences, seed 0, 2^15 buckets, 60 L-BFGS steps),
# tagging the next 500 of each corpus; the JAX package's CPU accuracy and
# final NLL on them (`crf_tagger(task)` and its ``nll`` at the fitted
# theta, on a one-device mesh; `tests/test_torch_crf.py` holds the same
# objective and fit at small sizes)
NLP_N_TRAIN, NLP_N_TEST, NLP_MAX_ITER = 4000, 500, 60
NLP_POS_JAX_ACC, NLP_POS_JAX_NLL = 1.0, 0.15941795706748962
NLP_NER_JAX_ACC, NLP_NER_JAX_NLL = 1.0, 0.03409198671579361
NLP_ACC_FLOOR = 0.97      # tests/test_crf_tagger.py's bar
NLP_ACC_GAP = 0.005
#: the card's final NLL at most this far above JAX's, relative. Held one
#: way: near the optimum the float32 gradient is rounding (at the fitted
#: NER theta the CPU's float32 gradient is 0.50e-3 from float64's, its
#: max 0.49e-3), so where L-BFGS stops under JAX's 1e-7 rule moves with
#: the card's atomics; a fit that ends lower is no worse
NLP_NLL_RTOL = 1e-3
#: the card's objective at its theta against the CPU path's, both in
#: float64 (the same function): the value relative, the gradient against
#: max|gradient|. In float32 the CPU's own value is 3e-4 from float64's
#: there, so float32 figures are printed, not held
NLP_VALUE_RTOL, NLP_GRAD_RTOL = 1e-5, 1e-6
NLP_PERCEPTRON_SENTENCES, NLP_PERCEPTRON_ITERS = 600, 3
# phase 31: a collective's wait for its peers (one rank: none)
PARALLEL_TIMEOUT_S = 120.0
# phase 32: two ranks on the card's (1, 2) mesh; the slice's accuracy
# (PERF.md §5) and the band around it; predictions that may differ from
# phase 31's one-process run (0.1% of the test rows); run_fused's W
# against one process's (JAX's own atol between mesh shapes)
MODEL_AXIS_TIMEOUT_S = 300.0
MODEL_AXIS_ACC, MODEL_AXIS_ACC_TOL = 0.831, 0.005
MODEL_AXIS_PRED_DIFF = N_TEST // 1000
MODEL_AXIS_W_ATOL = 2e-3
#: the sharding planner's choices, computed by `model_axis_static` on the
#: CPU (`python -c "import chip_smoke; print(chip_smoke.model_axis_static(
#: 'cpu'))"`): per graph and layout, [default boundary bytes, planned
#: boundary bytes, improved, the chosen families in vertex order, run-
#: length coded: d data, dm data_model, m model, r replicated]
MODEL_AXIS_PINNED = {
    "LinearPixels@2x4": [22176, 0, True, "d3 dm5 d3"],
    "LinearPixels@8x1": [0, 0, False, "d11"],
    "MnistRandomFFT@2x4": [10752, 0, True, "d27"],
    "MnistRandomFFT@8x1": [0, 0, False, "d27"],
    "RandomPatchCifar.fit@2x4": [2508800000, 0, True,
                                 "d2 dm3 d1 dm7 d5"],
    "RandomPatchCifar.fit@8x1": [0, 0, False, "d18"],
    "RandomPatchCifar.test@2x4": [1792000000, 0, True,
                                  "d2 dm3 d1 dm7 d5"],
    "RandomPatchCifar.test@8x1": [0, 0, False, "d18"],
    "RandomPatchCifar@2x4": [672, 0, True,
                             "d10 dm2 d6 dm2 d4 dm2 d1 dm1 d1 dm1 d3"],
    "RandomPatchCifar@8x1": [0, 0, False, "d33"],
    "TimitPipeline@2x4": [10752, 0, True, "d2 dm3 d4"],
    "TimitPipeline@8x1": [0, 0, False, "d9"],
}
NLP_ANNOTATED = 16        # held-out NER sentences through the extractor
# phase 33: two ranks on the card's (2, 1) mesh. Models as shares of
# their largest entry against the one-process run's: KRR's alpha (the
# blocks are one process's rows; each rank's KA update rounds otherwise
# over its rows, and the augmented kernel's 98 blocks carry that
# further than RandomPatchCifarKernel's 25: a one-process refit of the
# ranks' own rows sits as far from theirs as one process's fit does),
# BCD's W (one solve of normal equations whose Gram is summed in two
# parts; the whole run's gap is not isolated); the test predictions that
# may differ (ImageNet's: a thousandth of its test images; a confusion's
# entries moved, counted once a prediction), the accuracies' gap, VOC's
# mAP gap; BWLS alone (VOC from sideband files of phase 15's PCA and
# GMM: W and test scores); and VOC fitted whole, where TSQR over two
# ranks' R factors moves the PCA's components (absolute, each up to its
# sign) and the GMM fitted on its projection (k-means++'s draws, 30 EM
# steps) carries that into its means, W and the scores. The last five
# limits are about twice the readings on an H100 80GB HBM3 at 700 W, the
# differences isolated upstream of BWLS
DATA_AXIS_TIMEOUT_S = 600.0
DATA_AXIS_ALPHA_RTOL = 1e-5
DATA_AXIS_AUG_ALPHA_RTOL = 5e-5
DATA_AXIS_BCD_W_RTOL = 1e-3
DATA_AXIS_WHOLE_BCD_W_RTOL = 5e-3
DATA_AXIS_PRED_DIFF = N_TEST // 1000
DATA_AXIS_IMAGENET_PRED_DIFF = IMAGENET_N_TEST // 1000
DATA_AXIS_ACC_TOL = 0.005
DATA_AXIS_MAP_TOL = 1e-3
DATA_AXIS_BWLS_RTOL = 1e-4
DATA_AXIS_PCA_ATOL = 1.5e-3
DATA_AXIS_GMM_RTOL = 1e-2
DATA_AXIS_W_RTOL = 3.5e-2
DATA_AXIS_SCORE_RTOL = 7e-3
#: the one-process phases' results phase 33 is held to
DATA_AXIS_REF: dict = {}

# phase 34, written before its first run on the card: the limits each
# rank is held to against this run's one-process phases 17-19 and 21
# (naive Bayes' log-conditionals as a share of their largest; the
# Amazon test predictions that may move, a thousandth of 4,000; the
# sparse fit's last objective, relative, and W, a share of max|W|) and,
# in each rank, against one process's fit of the whole rows (the dense
# estimators, a share of their largest entry); the kernel generator's
# rows (seeded on the card, scaled to unit expected norm) and γ
TEXT_AXIS_TIMEOUT_S = 400.0
TEXT_AXIS_NB_RTOL = 1e-6
TEXT_AXIS_AMAZON_MOVED = (AMAZON_N - int(0.8 * AMAZON_N)) // 1000
TEXT_AXIS_SPARSE_OBJECTIVE_RTOL = 1e-5
TEXT_AXIS_SPARSE_W_RTOL = 1e-3
TEXT_AXIS_DENSE_RTOL = 1e-6
KGEN_D, KGEN_ANCHORS, KGEN_ROWS, KGEN_GAMMA = 2048, 4096, 25_000, 0.5
#: the one-process phases' results phase 34 is held to
TEXT_AXIS_REF: dict = {}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(title: str, /, **fields) -> None:
    print(f"{title}: {json.dumps(fields)}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` single calls timed with CUDA events, warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def device_ms(calls, reps: int = 5) -> float:
    """Device time per launch: ``calls`` run once to warm up (builds,
    plans, allocations, attributes), then captured in order into one
    CUDA graph, replayed between two events; the median over ``reps``
    replays, divided by the number of calls."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def host_ms(fn, count: int, reps: int = 5):
    """(wall clock per call with a sync at the end, host time per call
    to enqueue): ``fn`` makes ``count`` calls; medians over ``reps``."""
    fn()
    torch.cuda.synchronize()
    wall, enqueue = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append(1e3 * (t1 - t0) / count)
        wall.append(1e3 * (t2 - t0) / count)
    return statistics.median(wall), statistics.median(enqueue)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / scale


def k1_bound_ms(n, h, w, c, patch, k, pool, stride):
    """(ms, bound_by): the conv's products at the positions some pool
    window covers (all 27x27 at 32x32 pool 14 stride 13; 12x12 of 19x19
    at 24x24 pool 12 stride 11), at the bf16 peak, against each input
    read once and each output written once at the HBM rate."""
    ph, pw = h - patch + 1, w - patch + 1
    gy, gx = (ph - pool) // stride + 1, (pw - pool) // stride + 1
    cy, cx = min(ph, (gy - 1) * stride + pool), min(pw, (gx - 1) * stride
                                                     + pool)
    flops = 2.0 * n * cy * cx * c * patch * patch * k
    nbytes = 4.0 * (n * h * w * c + c * patch * patch * k + 2 * k
                    + n * gy * gx * 2 * k)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def k2_bound_ms(n, h, w, k, pool, gy, gx):
    """(ms, bound_by): six fp32 operations per window value (two
    subtractions, two maxima, two sums) against the bytes moved."""
    flops = 6.0 * n * gy * gx * pool * pool * k
    nbytes = 4.0 * (n * h * w * k + n * gy * gx * 2 * k)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def k4_bound_ms(n, layout):
    """(ms, bound_by): each row read once and written once (plus the
    stages' vectors) against two fp32 operations per element per stage,
    an upper count. ``layout.lens`` describes one segment of a row."""
    in_len = layout.lens[0] * layout.segments
    out_len = math.prod(layout.out_shape)
    nbytes = 4.0 * (n * in_len + n * out_len + layout.packed.numel())
    flops = 2.0 * n * sum(layout.lens) * layout.segments
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def k5_bound_ms(m, n, d):
    """(ms, bound_by): three TF32 tensor-core products of 2·m·n·d
    operations each (the fp32-accurate product of the TPU kernel's
    Precision.HIGHEST, done as hi·lo + lo·hi + hi·hi) at the TF32 rate,
    against X and Yb read once and the block written once."""
    flops = 3 * 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d + m * n)
    t_ops, t_bytes = flops / TF32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations (3xTF32)"
                                       if t_ops > t_bytes else "bytes")


def run_stages(steps):
    """Run ``(name, fn)`` steps in order, each closed by a device sync:
    ({name: seconds}, their sum, the last step's result). The pipelines'
    nodes fit lazily, so forcing them one by one stages the same run that
    a plain call would make."""
    seconds, out = {}, None
    for step, fn in steps:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[step] = time.perf_counter() - t
    return seconds, sum(seconds.values()), out


def count_syncs(fn):
    """({source line: count}, total) of the calls in ``fn`` that wait for
    the card (`keystone_tpu_torch/utils/profiling.py::count_syncs`)."""
    from keystone_tpu_torch.utils.profiling import count_syncs

    return count_syncs(fn)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count
    (`keystone_tpu_torch/utils/profiling.py::launch_counts`)."""
    from keystone_tpu_torch.utils.profiling import launch_counts

    return launch_counts()


def cut(pipeline, k: int):
    """``pipeline`` ending at the ``k``-th node of its data path: the same
    nodes, so a run of it fills the prefix table for the whole one."""
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    end = pipeline.data_path()[k - 1]
    return Pipeline(pipeline.graph.set_sink_dependency(pipeline.sink, end),
                    pipeline.source, pipeline.sink)


def fused_in_plan(result):
    """The `FusedBatchTransformer`s of a lazy result's optimized plan,
    those inside fused chains included."""
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    out = []
    for op in result.executor.optimized_graph.operators.values():
        for s in getattr(op, "stage_specs", [op]):
            if isinstance(s, FusedBatchTransformer):
                out.append(s)
                out.extend(t for t in s.stages
                           if isinstance(t, FusedBatchTransformer))
    return out


class WorkflowHostClock:
    """While open, the host seconds of each executor's optimizer run and
    structural check, summed: ``executors`` (optimizer runs),
    ``optimize_seconds``, ``checks`` and ``check_seconds``. It wraps the
    prefix table's optimizer and `analysis.structural_report`."""

    def __init__(self):
        self.totals = dict(executors=0, optimize_seconds=0.0, checks=0,
                           check_seconds=0.0)

    def _add(self, count, seconds, t0):
        self.totals[count] += 1
        self.totals[seconds] += time.perf_counter() - t0

    def __enter__(self):
        import keystone_tpu_torch.analysis as analysis
        from keystone_tpu_torch.workflow import PipelineEnv

        clock, env = self, PipelineEnv.get()
        optimizer = self._optimizer = env.get_optimizer()
        report = self._report = analysis.structural_report

        class Timed:
            def __getattr__(self, name):
                return getattr(optimizer, name)

            def execute(self, *args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return optimizer.execute(*args, **kwargs)
                finally:
                    clock._add("executors", "optimize_seconds", t0)

        def timed_report(graph):
            t0 = time.perf_counter()
            try:
                return report(graph)
            finally:
                clock._add("checks", "check_seconds", t0)

        env.set_optimizer(Timed())
        analysis.structural_report = timed_report
        return self

    def __exit__(self, *exc):
        import keystone_tpu_torch.analysis as analysis
        from keystone_tpu_torch.workflow import PipelineEnv

        PipelineEnv.get().set_optimizer(self._optimizer)
        analysis.structural_report = self._report
        return False


def host_split(steps):
    """``steps`` run once more as `run_stages` runs them, under a
    `WorkflowHostClock`: {step: its seconds, executors, the optimizer's
    and the structural check's host seconds}."""
    out = {}
    with WorkflowHostClock() as clock:
        for step, fn in steps:
            before = dict(clock.totals)
            seconds, _, _ = run_stages([(step, fn)])
            out[step] = dict(seconds=seconds[step], **{
                k: clock.totals[k] - before[k] for k in before})
    return out


def fused_microbatches(*counts) -> int:
    """Microbatches of the optimizer's fused chains over host datasets of
    ``counts`` items, whose buckets run in chunks of the resolved chunk
    size (a padded tail is one microbatch too)."""
    from keystone_tpu_torch.workflow.env import resolved_chunk_size
    from keystone_tpu_torch.workflow.fusion_rule import NodeFusionRule

    mb, chunk = NodeFusionRule.microbatch, resolved_chunk_size()
    return sum(math.ceil(min(chunk, n - i) / mb)
               for n in counts for i in range(0, n, chunk))


def timed_s(fn):
    """(seconds of ``fn()`` closed by a device sync, its result)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def pca_routes(pipeline) -> list:
    """Each `ColumnPCAEstimator` of a run pipeline's graph: the route its
    cost models chose, both costs under the card's resolved weights, the
    profile it priced, and the route the JAX package's formulas give
    under JAX's analytic CPU weights."""
    from keystone_tpu_torch.nodes.learning.pca import (
        ColumnPCAEstimator,
        DistributedPCACostModel,
        LocalPCACostModel,
    )

    out = []
    # one estimator may stand at several vertices before CSE merges them
    ests = {id(op): op for op in pipeline.graph.operators.values()
            if isinstance(op, ColumnPCAEstimator)}
    for op in ests.values():
        p = op.cost_profile
        check(p is not None, "a ColumnPCAEstimator was never priced")
        jax_costs = {"local": LocalPCACostModel().cost(p, *JAX_CPU_WEIGHTS),
                     "distributed": DistributedPCACostModel().cost(
                         p, *JAX_CPU_WEIGHTS)}
        out.append(dict(
            pca_route=op.chosen, costs_card_weights=op.costs,
            profile=dict(n=p.n, d=p.d, k=p.k, num_chips=p.num_chips),
            jax_formulas_route=("local" if jax_costs["local"]
                                <= jax_costs["distributed"]
                                else "distributed"),
            jax_formulas_costs=jax_costs))
    check(out and all(r["pca_route"] == r["jax_formulas_route"]
                      for r in out), f"PCA routes {out} differ from the "
          "JAX formulas' or are missing")
    return out


def precision_trails(mark: int) -> list:
    """The storage trails the precision planners enforced since ledger
    ``mark``: "rule program: dtypes" for each tagged program, sorted."""
    from keystone_tpu_torch.telemetry import ledger

    return sorted(
        f"{r['rule']} {(r['labels'] or [''])[0]}: "
        + "/".join(str(d) for d in r["chosen"].get("storage", []))
        for r in ledger.session_since(mark) if r["kind"] == "precision")


def voc_phase(dev, card) -> int:
    """Phase 15: VOCSIFTFisher at the reference's widths; returns the
    chain kernel's launches in its run."""
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import voc_sift_fisher
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv

    vc_config = voc_sift_fisher.VOCSIFTFisherConfig(
        num_classes=VOC_CLASSES, pca_dims=VOC_PCA_DIMS, gmm_k=VOC_GMM_K)
    t0 = time.perf_counter()
    vc_train = voc_sift_fisher._synthetic_voc(VOC_N_TRAIN, VOC_CLASSES,
                                              vc_config.seed)
    vc_test = voc_sift_fisher._synthetic_voc(VOC_N_TEST, VOC_CLASSES,
                                             vc_config.seed + 1)
    vc_data_seconds = time.perf_counter() - t0
    voc_sift_fisher.run_on(
        HostDataset(vc_train.items[:SIFT_FISHER_WARM]),
        HostDataset(vc_test.items[:SIFT_FISHER_WARM]), vc_config, dev)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mark = ledger.session_mark()
    vc = voc_sift_fisher.run_on(vc_train, vc_test, vc_config, dev)
    vc_precision = precision_trails(mark)
    vc_peak = torch.cuda.max_memory_allocated()
    vc_launches = launch_counts()
    from keystone_tpu_torch.workflow.env import planned_chunk_size

    VOC_PLAN.update(planned_chunk=planned_chunk_size(),
                    peak_mem_bytes=vc_peak)
    # the same run one stage at a time, each closed by a device sync
    vc_tr = HostDataset(vc_train.items, device=dev)
    vc_te = HostDataset(vc_test.items, device=dev)
    vc_model = voc_sift_fisher.build(vc_tr, vc_config, dev)
    vc_labels = [list(x.labels) for x in vc_test.items]
    vc_stages, _, vc_staged_map = run_stages([
        ("sift", lambda: vc_model.sift(vc_tr).get()),
        ("pca_fit", lambda: vc_model.pca.fitted()),
        ("gmm_fit", lambda: vc_model.fisher.fitted()),
        ("fisher_encode", lambda: vc_model.featurizer(vc_tr).get()),
        ("bwls_fit", lambda: vc_model.predictor.fitted()),
        ("predict_map", lambda: MeanAveragePrecisionEvaluator(VOC_CLASSES)(
            vc_model.predictor(vc_te), vc_labels).mean()),
    ])
    del vc_model
    vc_syncs, vc_sync_count = count_syncs(
        lambda: voc_sift_fisher.run_on(vc_train, vc_test, vc_config, dev))
    # the card's fitted PCA, GMM and (W, b) on the CPU, first test images
    model = vc["model"]
    gmm = model.fisher.fitted().gmm
    solver = model.predictor.fitted()
    cpu_predictor = convert.fitted_voc_predictor(*[
        t.cpu().numpy() for t in (
            model.pca.fitted().components, gmm.means, gmm.variances,
            gmm.weights, solver.W, solver.b)],
        device="cpu")
    cpu_scores = cpu_predictor(HostDataset(
        vc_test.items[:VOC_CPU_CHECK], device="cpu")).get().numpy()
    card_scores = vc["scores"].array[:VOC_CPU_CHECK].cpu().numpy()
    vc_cpu_rel = float(np.abs(cpu_scores - card_scores).max()
                       / np.abs(card_scores).max())
    vc_cpu_argmax = bool((cpu_scores.argmax(1)
                          == card_scores.argmax(1)).all())
    vc_features = solver.W.shape[0]
    vc_pca = pca_routes(model.predictor)
    DATA_AXIS_REF.update(
        voc_map=vc["map"], voc_W=solver.W.cpu().numpy(),
        voc_scores=vc["scores"].numpy(),
        voc_pca=model.pca.fitted().components.cpu().numpy(),
        voc_gmm_means=gmm.means.cpu().numpy(),
        voc_gmm_variances=gmm.variances.cpu().numpy(),
        voc_gmm_weights=gmm.weights.cpu().numpy(), voc_pca_route=vc_pca,
        voc_precision=vc_precision)
    phase("voc", seconds=vc["seconds"], images_per_sec=vc["images_per_sec"],
          rate_basis="train+test images", train_images=len(vc_train),
          test_images=len(vc_test), features=vc_features,
          mean_average_precision=vc["map"], jax_cpu_map=VOC_JAX_MAP,
          gap_to_jax_cpu=vc["map"] - VOC_JAX_MAP,
          staged_stage_seconds=vc_stages, staged_map=vc_staged_map,
          cpu_check_images=VOC_CPU_CHECK, cpu_score_rel_diff=vc_cpu_rel,
          cpu_argmax_equal=vc_cpu_argmax, pca=vc_pca, syncs=vc_sync_count,
          sync_lines=vc_syncs, data_seconds=vc_data_seconds,
          peak_mem_bytes=vc_peak, launches=vc_launches, card=card)
    check(abs(vc["map"] - VOC_JAX_MAP) <= 0.01, f"VOCSIFTFisher mAP "
          f"{vc['map']} is not within 0.01 of {VOC_JAX_MAP}")
    check(vc_features == 2 * VOC_PCA_DIMS * VOC_GMM_K,
          f"VOCSIFTFisher has {vc_features} features")
    check(vc_cpu_argmax and vc_cpu_rel <= VOC_CPU_SCORE_RTOL,
          f"the CPU path's VOC scores differ from the card's by "
          f"{vc_cpu_rel} of max|score| (argmax equal: {vc_cpu_argmax})")
    # the chain kernel, once a fused microbatch, for the two chains the
    # fusion pass tags (PixelScaler >> GrayScaler, the Fisher-vector
    # tail) over the train and test images, and once more for the gray
    # chain over NodeOptimizationRule's sample of three images; no other
    # kernel
    vc_k4 = vc_launches["elementwise_chain"]
    vc_k4_want = 2 * fused_microbatches(len(vc_train), len(vc_test)) + 1
    others = {k: n for k, n in vc_launches.items()
              if n and k != "elementwise_chain"}
    check(vc_k4 == vc_k4_want and not others, f"VOCSIFTFisher launched "
          f"{vc_launches}, not elementwise_chain {vc_k4_want} times alone")
    return vc_k4


#: VOCSIFTFisher's planned chunk and peak memory, for the planners phase
VOC_PLAN: dict = {}


def imagenet_phase(dev, card) -> int:
    """Phase 16: ImageNetSiftLcsFV at the JAX configuration's widths;
    returns the chain kernel's launches in its run."""
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv

    im_config = imagenet_sift_lcs_fv.ImageNetSiftLcsFVConfig()
    im_train = imagenet_sift_lcs_fv._synthetic_imagenet(
        IMAGENET_N_TRAIN, im_config.num_classes, im_config.seed)
    im_test = imagenet_sift_lcs_fv._synthetic_imagenet(
        IMAGENET_N_TEST, im_config.num_classes, im_config.seed + 1)
    imagenet_sift_lcs_fv.run_on(
        HostDataset(im_train.items[:SIFT_FISHER_WARM]),
        HostDataset(im_test.items[:SIFT_FISHER_WARM]), im_config, dev)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mark = ledger.session_mark()
    im = imagenet_sift_lcs_fv.run_on(im_train, im_test, im_config, dev)
    im_launches = launch_counts()
    im_features = im["predictor"].fitted().W.shape[0]
    im_pca = pca_routes(im["predictor"])
    DATA_AXIS_REF.update(
        imagenet_accuracy=im["test_accuracy"],
        imagenet_preds=im["predictions"].numpy(),
        imagenet_W=im["predictor"].fitted().W.cpu().numpy(),
        imagenet_pca_route=im_pca, imagenet_precision=precision_trails(mark))
    phase("imagenet", seconds=im["seconds"],
          images_per_sec=im["images_per_sec"],
          rate_basis="train+test images", train_images=len(im_train),
          test_images=len(im_test), features=im_features,
          test_accuracy=im["test_accuracy"],
          jax_cpu_test_accuracy=IMAGENET_JAX_ACC,
          gap_to_jax_cpu=im["test_accuracy"] - IMAGENET_JAX_ACC,
          pca=im_pca, peak_mem_bytes=torch.cuda.max_memory_allocated(),
          launches=im_launches, card=card)
    check(abs(im["test_accuracy"] - IMAGENET_JAX_ACC) <= 0.01,
          f"ImageNetSiftLcsFV test accuracy {im['test_accuracy']} is not "
          f"within 0.01 of {IMAGENET_JAX_ACC}")
    # the chain kernel, once a fused microbatch, for each branch's
    # Fisher-vector tail over the train and test images; no other kernel
    im_k4 = im_launches["elementwise_chain"]
    im_k4_want = 2 * fused_microbatches(len(im_train), len(im_test))
    others = {k: n for k, n in im_launches.items()
              if n and k != "elementwise_chain"}
    check(im_k4 == im_k4_want and not others, f"ImageNetSiftLcsFV launched "
          f"{im_launches}, not elementwise_chain {im_k4_want} times alone")
    return im_k4


def text_stages(model, train, test, evaluate, predict_train: bool):
    """A text model's run one stage at a time, each closed by a device
    sync (`run_stages`): ({stage: seconds}, their sum, ``evaluate``'s
    result on the predictions, the train and test CSRs). The training
    documents' CSR goes to the card with its transpose, which scipy
    builds on the host first. ``predict_train``: the train documents are
    scored too, as Newsgroups' clock scores them."""
    out = {}
    steps = [
        ("featurize_train", lambda: model.featurizer(train).get()),
        ("vocabulary_fit", lambda: model.vocabulary.fitted()),
        ("vectorize_train", lambda: out.setdefault(
            "X", model.vectorizer(train).get())),
        ("to_device_train", lambda: (out["X"].csr(), out["X"].csr_t())),
        ("fit", lambda: model.classifier.fitted()),
        ("featurize_test", lambda: model.featurizer(test).get()),
        ("vectorize_test", lambda: out.setdefault(
            "Xt", model.vectorizer(test).get())),
        ("to_device_test", lambda: out["Xt"].csr()),
        ("predict", lambda: out.setdefault(
            "pred", (model.predictor(train).get() if predict_train
                     else None, model.predictor(test).get()))),
        ("evaluate", lambda: evaluate(*out["pred"])),
    ]
    seconds, total, result = run_stages(steps)
    return seconds, total, result, out["X"], out["Xt"]


def host_transpose_s(X) -> float:
    """Seconds of scipy's host transpose of a CSR, which the copy of
    Xᵀ to the card includes."""
    t = time.perf_counter()
    X.matrix.T.tocsr()
    return time.perf_counter() - t


def objective64(X, y, W, lam) -> float:
    """The softmax objective −Σ(logits·onehot − logsumexp)/n + ½λ‖W‖² in
    float64 on the host, from a scipy CSR and W."""
    L = X.astype(np.float64) @ np.asarray(W, np.float64)
    m = L.max(1, keepdims=True)
    logz = (m + np.log(np.exp(L - m).sum(1, keepdims=True)))[:, 0]
    return float(-np.sum(L[np.arange(len(y)), y] - logz) / len(y)
                 + 0.5 * lam * np.sum(np.asarray(W, np.float64) ** 2))


def vocab_digest(vocab: dict) -> str:
    """SHA-256 of a vocabulary's (feature, column) pairs in column
    order: equal digests, equal vocabularies."""
    import hashlib

    h = hashlib.sha256()
    for f, i in sorted(vocab.items(), key=lambda kv: kv[1]):
        h.update(repr((f, i)).encode())
    return h.hexdigest()


def newsgroups_phase(dev, card) -> None:
    """Phase 17: NewsgroupsPipeline at the reference's widths; its
    vocabulary, naive Bayes model, test predictions and accuracy go to
    `TEXT_AXIS_REF`."""
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.learning.classifiers import (
        NaiveBayesEstimator,
    )
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import text_pipelines as tp
    from keystone_tpu_torch.workflow import PipelineEnv

    config = tp.NewsgroupsConfig(num_classes=NEWS_CLASSES,
                                 common_features=TEXT_FEATURES)
    t0 = time.perf_counter()
    train_labels, train_docs = tp.synthetic_corpus(NEWS_N_TRAIN,
                                                   NEWS_CLASSES, seed=0)
    test_labels, test_docs = tp.synthetic_corpus(NEWS_N_TEST, NEWS_CLASSES,
                                                 seed=1)
    data_seconds = time.perf_counter() - t0
    few = [HostDataset(d.items[:TEXT_WARM]) for d in (
        train_labels, train_docs, test_labels, test_docs)]
    tp.run_newsgroups_on(*few, NEWS_CLASSES, config, dev)
    # the synchronizing calls of a run; their count does not grow with the
    # corpus (no loop on the host waits for the card), so a warm-sized run
    syncs, sync_count = count_syncs(
        lambda: tp.run_newsgroups_on(*few, NEWS_CLASSES, config, dev))
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    kernels.reset_launches()
    nw = tp.run_newsgroups_on(train_labels, train_docs, test_labels,
                              test_docs, NEWS_CLASSES, config, dev)
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    # the card's fitted vocabulary and model on the CPU, first test docs
    fitted = nw.pop("model")
    card_nb = fitted.classifier.fitted()
    vocab = fitted.vocabulary.fitted().vocab
    TEXT_AXIS_REF.update(
        news_vocab=vocab_digest(vocab),
        news_log_priors=card_nb.log_priors.cpu().numpy(),
        news_log_cond=card_nb.log_cond.cpu().numpy(),
        news_preds=nw.pop("predictions").numpy(),
        news_accuracy=nw["test_accuracy"])
    cpu_scorer = convert.fitted_text_predictor(
        vocab, convert.naive_bayes_model(
            card_nb.log_priors.cpu().numpy(), card_nb.log_cond.cpu().numpy(),
            "cpu"))
    cpu_scores = cpu_scorer(HostDataset(
        test_docs.items[:NEWS_CPU_CHECK], device="cpu")).get().numpy()
    card_scores = card_nb.apply_batch(fitted.vectorizer(HostDataset(
        test_docs.items[:NEWS_CPU_CHECK], device=dev)).get()).numpy()
    cpu_rel = float(np.abs(cpu_scores - card_scores).max()
                    / np.abs(card_scores).max())
    cpu_argmax = bool((cpu_scores.argmax(1) == card_scores.argmax(1)).all())
    width = len(vocab)
    # the staged run below starts with no earlier run's host objects alive
    del fitted, card_nb, cpu_scorer
    gc.collect()
    # the same run one stage at a time
    tr = HostDataset(train_docs.items, device=dev)
    te = HostDataset(test_docs.items, device=dev)
    model = tp.build_text_model(tr, train_labels,
                                NaiveBayesEstimator(NEWS_CLASSES))
    evaluator = MulticlassClassifierEvaluator(NEWS_CLASSES)
    stages, staged_total, staged_acc, X, Xt = text_stages(
        model, tr, te, lambda p_tr, p_te: (
            evaluator(p_tr, train_labels.items),
            evaluator(p_te, test_labels.items).accuracy)[1], True)
    # the two CSR products, on the card between events
    nb = model.classifier.fitted()
    onehot = torch.nn.functional.one_hot(torch.as_tensor(
        train_labels.items, device=dev), NEWS_CLASSES).float()
    products_ms = {
        "fit_Xt_onehot": time_ms(lambda: X.csr_t() @ onehot),
        "scores_X_log_cond": time_ms(lambda: Xt.csr() @ nb._log_cond_t),
    }
    transpose_s = host_transpose_s(X)
    del model, tr, te
    phase("newsgroups", seconds=nw["seconds"],
          docs_per_sec=nw["docs_per_sec"], rate_basis="train+test documents",
          train_docs=NEWS_N_TRAIN, test_docs=NEWS_N_TEST,
          classes=NEWS_CLASSES, features=width, train_nnz=X.nnz,
          test_nnz=Xt.nnz, test_accuracy=nw["test_accuracy"],
          jax_cpu_test_accuracy=NEWS_JAX_ACC,
          gap_to_jax_cpu=nw["test_accuracy"] - NEWS_JAX_ACC,
          staged_stage_seconds=stages, staged_seconds=staged_total,
          staged_test_accuracy=staged_acc,
          host_transpose_seconds=transpose_s, products_ms=products_ms,
          cpu_check_docs=NEWS_CPU_CHECK, cpu_score_rel_diff=cpu_rel,
          cpu_argmax_equal=cpu_argmax, syncs=sync_count,
          sync_lines=syncs, syncs_counted_on=f"{TEXT_WARM}+{TEXT_WARM} docs",
          data_seconds=data_seconds, peak_mem_bytes=peak,
          mem_at_start_bytes=start_mem, peak_over_start_bytes=peak
          - start_mem, launches=launches, card=card)
    check(abs(nw["test_accuracy"] - NEWS_JAX_ACC) <= 0.005,
          f"NewsgroupsPipeline test accuracy {nw['test_accuracy']} is not "
          f"within 0.005 of {NEWS_JAX_ACC}")
    check(width == TEXT_FEATURES, f"NewsgroupsPipeline has {width} features")
    check(cpu_argmax and cpu_rel <= NEWS_CPU_SCORE_RTOL,
          f"the CPU path's Newsgroups scores differ from the card's by "
          f"{cpu_rel} of max|score| (argmax equal: {cpu_argmax})")
    check(not any(launches.values()),
          f"NewsgroupsPipeline launched kernels: {launches}")


def amazon_phase(dev, card) -> dict:
    """Phase 18: AmazonReviewsPipeline, logistic regression by L-BFGS;
    returns the staged run's training and test CSRs and their labels.
    The run's vocabulary, W, float64 objective, test predictions,
    accuracy and F1 go to `TEXT_AXIS_REF`."""
    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.evaluation import BinaryClassifierEvaluator
    from keystone_tpu_torch.nodes.learning.classifiers import (
        LogisticRegressionEstimator,
    )
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import text_pipelines as tp
    from keystone_tpu_torch.workflow import PipelineEnv

    config = tp.AmazonReviewsConfig(common_features=TEXT_FEATURES,
                                    lam=AMAZON_LAM)
    t0 = time.perf_counter()
    labels, docs = tp.synthetic_corpus(AMAZON_N, 2, seed=0)
    data_seconds = time.perf_counter() - t0
    few = [HostDataset(d.items[:2 * TEXT_WARM]) for d in (labels, docs)]
    tp.run_amazon_on(*few, config, dev)
    run_syncs, run_sync_count = count_syncs(
        lambda: tp.run_amazon_on(*few, config, dev))
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    kernels.reset_launches()
    am = tp.run_amazon_on(labels, docs, config, dev)
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    est = am.pop("estimator")
    model = am.pop("model")
    n_train = int(0.8 * AMAZON_N)
    X = model.vectorizer(model.train_docs).get()
    y = np.asarray(labels.items[:n_train], np.int64)
    W = model.classifier.fitted().W
    objective = objective64(X.matrix, y, W.cpu().numpy(), AMAZON_LAM)
    TEXT_AXIS_REF.update(
        amazon_vocab=vocab_digest(model.vocabulary.fitted().vocab),
        amazon_W=W.cpu().numpy(), amazon_objective=objective,
        amazon_preds=am.pop("predictions").numpy(),
        amazon_accuracy=am["test_accuracy"], amazon_f1=am["f1"])
    y_dev = Dataset(y.astype(np.int32), device=dev)
    card_objective = float(est.objective(X, y_dev)(W)[0])
    # one fit's synchronizing calls, on the run's training CSR
    refit = LogisticRegressionEstimator(2, lam=AMAZON_LAM)
    fit_syncs, fit_sync_count = count_syncs(lambda: refit.fit(X, y_dev))
    # the staged run below starts with no earlier run's host objects alive
    del model, X
    gc.collect()
    # the same run one stage at a time
    tr = HostDataset(docs.items[:n_train], device=dev)
    te = HostDataset(docs.items[n_train:], device=dev)
    staged = tp.build_text_model(
        tr, y_dev, LogisticRegressionEstimator(2, lam=AMAZON_LAM))
    actual = np.asarray(labels.items[n_train:], bool)
    stages, staged_total, staged_acc, Xs, Xt = text_stages(
        staged, tr, te, lambda p_tr, p_te: BinaryClassifierEvaluator()(
            p_te, actual).accuracy, False)
    resid = torch.randn(n_train, 2, device=dev)
    products_ms = {"X_W": time_ms(lambda: Xs.csr() @ W),
                   "Xt_resid": time_ms(lambda: Xs.csr_t() @ resid)}
    transpose_s = host_transpose_s(Xs)
    del staged, tr, te
    steps = est.linesearch_steps
    phase("amazon", seconds=am["seconds"], docs_per_sec=am["docs_per_sec"],
          rate_basis="train+test documents", train_docs=n_train,
          test_docs=AMAZON_N - n_train, features=Xs.dim, train_nnz=Xs.nnz,
          test_accuracy=am["test_accuracy"], f1=am["f1"],
          jax_cpu_test_accuracy=AMAZON_JAX_ACC, jax_cpu_f1=AMAZON_JAX_F1,
          objective=objective, card_objective_fp32=card_objective,
          jax_cpu_objective=AMAZON_JAX_OBJECTIVE,
          objective_rel_gap=objective / AMAZON_JAX_OBJECTIVE - 1.0,
          loss_history_first_last=[est.loss_history[0],
                                   est.loss_history[-1]],
          linesearch_evals=sum(steps), linesearch_per_step=steps,
          fit_syncs=fit_sync_count, fit_sync_lines=fit_syncs,
          fit_syncs_linesearch_evals=sum(refit.linesearch_steps),
          run_syncs=run_sync_count, run_sync_lines=run_syncs,
          run_syncs_counted_on=f"{2 * TEXT_WARM} docs",
          staged_stage_seconds=stages, staged_seconds=staged_total,
          staged_test_accuracy=staged_acc,
          host_transpose_seconds=transpose_s, products_ms=products_ms,
          data_seconds=data_seconds, peak_mem_bytes=peak,
          mem_at_start_bytes=start_mem, peak_over_start_bytes=peak
          - start_mem, launches=launches, card=card)
    check(abs(objective / AMAZON_JAX_OBJECTIVE - 1.0)
          <= AMAZON_OBJECTIVE_RTOL, f"AmazonReviewsPipeline objective "
          f"{objective} is not within {AMAZON_OBJECTIVE_RTOL} of JAX's "
          f"{AMAZON_JAX_OBJECTIVE}")
    check(abs(am["test_accuracy"] - AMAZON_JAX_ACC) <= 0.005,
          f"AmazonReviewsPipeline test accuracy {am['test_accuracy']} is "
          f"not within 0.005 of {AMAZON_JAX_ACC}")
    check(Xs.dim == TEXT_FEATURES, f"AmazonReviewsPipeline has {Xs.dim} "
          "features")
    check(not any(launches.values()),
          f"AmazonReviewsPipeline launched kernels: {launches}")
    return dict(train=Xs, train_labels=y, test=Xt,
                test_labels=actual.astype(np.int64))


def stupid_backoff_phase(dev, card) -> None:
    """Phase 19: StupidBackoffPipeline, host code in both packages; its
    result goes to `TEXT_AXIS_REF`."""
    from keystone_tpu_torch.pipelines import text_pipelines as tp

    sb = tp.run_stupid_backoff(tp.StupidBackoffConfig(n_synth=BACKOFF_N),
                               dev)
    TEXT_AXIS_REF["backoff"] = {k: sb[k] for k in (
        "vocab", "num_trigrams", "mean_log_score")}
    phase("stupid_backoff", seconds=sb["seconds"], docs=BACKOFF_N,
          vocab=sb["vocab"], num_trigrams=sb["num_trigrams"],
          mean_log_score=sb["mean_log_score"], jax_cpu=BACKOFF_JAX,
          runs_on="host (numpy and Python dicts), in both packages",
          card=card)
    check(sb["vocab"] == BACKOFF_JAX["vocab"]
          and sb["num_trigrams"] == BACKOFF_JAX["num_trigrams"]
          and abs(sb["mean_log_score"] - BACKOFF_JAX["mean_log_score"])
          <= BACKOFF_TOL, f"StupidBackoffPipeline gave {sb}, JAX "
          f"{BACKOFF_JAX}")


def workflow_phase(train, test, config, staged_seconds, staged_accuracy,
                   card) -> int:
    """Phase 20: RandomPatchCifar fit through the workflow's optimizer,
    saved, loaded on the card and applied to the test images; returns
    the chain kernel's launches in the fit and the apply."""
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.nodes.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel
    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.nodes.util.fusion import (
        FusedBatchTransformer,
        MegafusedBatchTransformer,
        _ConvRectifyPoolStage,
    )
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines.random_patch_cifar import build_pipeline
    from keystone_tpu_torch.workflow import (
        AutoCachingOptimizer,
        DefaultOptimizer,
        FittedPipeline,
        PipelineEnv,
    )
    from keystone_tpu_torch.workflow.optimizer import run_batch

    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    # the default optimizer's batches one at a time on the unfit graph:
    # host seconds and node count after each
    plan, batches = (build_pipeline(train, config).graph, {}), {}
    for batch in DefaultOptimizer().batches:
        t = time.perf_counter()
        plan = run_batch(batch, plan)
        batches[batch.name] = dict(host_seconds=time.perf_counter() - t,
                                   nodes=len(plan[0].operators))
    del plan
    PipelineEnv.reset()

    def fit():
        return build_pipeline(train, config).fit()

    kernels.reset_launches()
    fit_seconds, fitted = timed_s(fit)
    fit_launches = launch_counts()
    ops = list(fitted.graph.operators.values())
    megafused = [op for op in ops
                 if isinstance(op, MegafusedBatchTransformer)]
    featurizers = [s for op in megafused for s in op.stages
                   if isinstance(s, FusedBatchTransformer)
                   and any(isinstance(t, Convolver) for t in s.stages)]
    heads = [op for op in megafused if [type(s) for s in op.stages[1:]] == [
        StandardScalerModel, BlockLinearMapper, MaxClassifier]]
    fitted_form = [op.label for op in ops]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "random_patch_cifar.pkl")
        save_seconds, _ = timed_s(lambda: fitted.save(path))
        artifact_bytes = os.path.getsize(path)
        load_seconds, loaded = timed_s(
            lambda: FittedPipeline.load(path, device="cuda"))
    in_memory = fitted.apply(test.data).array
    for _ in range(2):  # warm: the first call runs eagerly, the second
        loaded.apply(test.data)  # captures the graph the timed one replays
    kernels.reset_launches()
    apply_seconds, predictions = timed_s(lambda: loaded.apply(test.data))
    apply_launches = launch_counts()
    bit_equal = torch.equal(predictions.array, in_memory)
    accuracy = evaluator(predictions, test.labels).accuracy
    peak = torch.cuda.max_memory_allocated()
    fit_syncs, fit_sync_count = count_syncs(fit)
    apply_syncs, apply_sync_count = count_syncs(
        lambda: loaded.apply(test.data))
    # one profile-guided caching plan of the unfit graph
    PipelineEnv.reset()
    auto = AutoCachingOptimizer("greedy")
    auto_seconds, _ = timed_s(
        lambda: auto.execute(build_pipeline(train, config).graph))
    chosen = [label for _, label in auto.batches[-1].rules[0].chosen]
    PipelineEnv.reset()
    phase("workflow", optimizer_batches=batches, fit_seconds=fit_seconds,
          staged_seconds=staged_seconds, fitted_form=fitted_form,
          fit_launches=fit_launches, save_seconds=save_seconds,
          artifact_bytes=artifact_bytes, load_seconds=load_seconds,
          test_apply_seconds=apply_seconds,
          test_images_per_sec=test.data.count / apply_seconds,
          apply_launches=apply_launches, test_accuracy=accuracy,
          staged_test_accuracy=staged_accuracy,
          loaded_equals_in_memory=bit_equal, fit_syncs=fit_sync_count,
          fit_sync_lines=fit_syncs, apply_syncs=apply_sync_count,
          apply_sync_lines=apply_syncs, autocache_seconds=auto_seconds,
          autocache_chosen=chosen, peak_mem_bytes=peak, card=card)
    fit_k1 = fit_launches["conv_rectify_pool"]
    apply_k1 = apply_launches["conv_rectify_pool"]
    train_mb = math.ceil(train.data.count / config.microbatch)
    test_mb = math.ceil(test.data.count / config.microbatch)
    check(fit_k1 == train_mb, f"Pipeline.fit launched conv_rectify_pool "
          f"{fit_k1} times for {train_mb} microbatches (CSE failed?)")
    check(apply_k1 == test_mb, f"the loaded pipeline launched "
          f"conv_rectify_pool {apply_k1} times for {test_mb} microbatches")
    check(len(featurizers) == 1 and isinstance(featurizers[0].fused[1],
                                               _ConvRectifyPoolStage)
          and len(heads) == 1 and len(ops) == 1, f"the fitted pipeline is "
          f"{fitted_form}, not one megafused chain of the featurizer, the "
          "scaler, the linear map and the argmax")
    check(bit_equal, "the loaded pipeline's predictions differ from the "
          "in-memory pipeline's")
    check(abs(accuracy - staged_accuracy) <= 0.002, f"the fitted pipeline's "
          f"test accuracy {accuracy} is not within 0.002 of the staged "
          f"pipeline's {staged_accuracy}")
    # every fused transformer tags its own chain-kernel run, but none
    # lowers here: the featurizer is one opaque stage of the megafused
    # chain, and the scaler, the only stage with a chain body, is
    # followed by the linear map
    k4 = fit_launches["elementwise_chain"] + apply_launches[
        "elementwise_chain"]
    check(k4 == 0 and heads and heads[0].planned_kernel is None,
          f"the fitted pipeline launched the chain kernel: {fit_launches}, "
          f"{apply_launches}")
    return k4


def lsq_objective64(X, Y, W, b, lam) -> float:
    """½‖XW + b − Y‖² + ½λ‖W‖² in float64 on the host, X a scipy CSR."""
    W = W.double().cpu().numpy()
    R = (X.astype(np.float64) @ W + b.double().cpu().numpy()
         - Y.double().cpu().numpy())
    return float(0.5 * np.sum(R * R) + 0.5 * lam * np.sum(W * W))


def calibration_section(dev, card) -> dict:
    """The cost weights measured on the card, written to
    smoke_out/cuda_calibration.json, beside the H100's published
    peaks and the weights resolved before the measurement."""
    from keystone_tpu_torch.nodes.learning import calibrate, cost_model

    resolved = cost_model.resolve_weights()
    committed = None
    if os.path.exists(cost_model.CALIBRATION_FILE):
        committed = cost_model.read_calibration(
            cost_model.CALIBRATION_FILE)[1]
    applied = (committed == cost_model.live_platform()
               and resolved != cost_model.ANALYTIC_CUDA)
    t = time.perf_counter()
    w = calibrate.calibrate_cost_weights(dev, CAL_GEMM_DIM, CAL_MEM_MB,
                                         CAL_ITERS)
    seconds = time.perf_counter() - t
    gemm_flops = 2.0 * CAL_GEMM_DIM**3
    mem_bytes = 2.0 * CAL_MEM_MB * (1 << 20)
    os.makedirs(OUT_DIR, exist_ok=True)
    calibrate.write_calibration(
        os.path.join(OUT_DIR, "cuda_calibration.json"), w, dict(
            nvidia_smi=card, power_limit=card.split(",")[-1].strip(),
            method=(f"keystone_tpu_torch.nodes.learning.calibrate."
                    f"calibrate_cost_weights(gemm_dim={CAL_GEMM_DIM}, "
                    f"mem_mb={CAL_MEM_MB}, iters={CAL_ITERS}): "
                    "dependency-chained fp32 GEMM (TF32 off) and "
                    "elementwise read+write probes between CUDA events, "
                    "timed at N and 2N steps and differenced, median of 3; "
                    "host_bw the best of 3 pinned host-to-device copies"),
            notes=("network_weight is the analytic NVLink 4 rate a "
                   "direction (450 GB/s, published): one card has no "
                   "link to measure"),
            script="chip_smoke.py phase 21 (least_squares)"))
    return dict(
        cpu_weight=w.cpu_weight, mem_weight=w.mem_weight,
        network_weight=w.network_weight, network_weight_measured=False,
        host_bw=w.host_bw, peak_flops=w.peak_flops, peak_bw=w.peak_bw,
        gemm_step_seconds=w.cpu_weight * gemm_flops,
        mem_step_seconds=w.mem_weight * mem_bytes,
        probe_sizes=dict(gemm_dim=CAL_GEMM_DIM, mem_mb=CAL_MEM_MB,
                         iters=CAL_ITERS),
        calibration_seconds=seconds,
        peak_flops_over_fp32_published=w.peak_flops / FP32_FLOPS,
        peak_bw_over_hbm_published=w.peak_bw / HBM_BYTES,
        committed_file_platform=committed, committed_file_applied=applied,
        resolved_weights=list(resolved))


def least_squares_phase(dev, card, amazon) -> None:
    """Phase 21: the cost-model solver choice (docstring)."""
    import scipy.sparse as sp

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.data.sparse import (
        PaddedSparseDataset,
        SparseDataset,
    )
    from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.nodes.learning.least_squares import (
        LeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.linear import normal_equations
    from keystone_tpu_torch.nodes.util.basic import (
        ClassLabelIndicatorsFromInt,
    )
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import timit

    kernels.reset_launches()
    calibration = calibration_section(dev, card)

    # TIMIT's features, as the solvers phase makes them
    tm_config = timit.TimitConfig(n_synth=TIMIT_N_SYNTH)
    tm_train, _, classes = timit.load(tm_config, dev)
    X = timit.featurizer(tm_train.data.array.shape[1], tm_config, dev)(
        tm_train.data).get().array
    Y = ClassLabelIndicatorsFromInt(classes)(tm_train.labels).get().array
    data, labels = tm_train.data.with_data(X), tm_train.data.with_data(Y)
    lam = tm_config.lam

    def objective(W, b):
        r = torch.addmm(b, X, W) - Y
        return float(0.5 * r.double().square().sum()
                     + 0.5 * lam * W.double().square().sum())

    lse = LeastSquaresEstimator(lam=lam)
    lse.fit(data, labels)  # warm
    fit_seconds, model = timed_s(lambda: lse.fit(data, labels))
    fitted = model.stages[-1] if hasattr(model, "stages") else model
    exact_seconds, (W, b) = timed_s(
        lambda: normal_equations(X, Y, X.shape[0], lam, True))
    timit_lsq = dict(n=X.shape[0], d=X.shape[1], k=Y.shape[1], lam=lam,
                     chosen=lse.chosen, costs_seconds=lse.costs,
                     fit_seconds=fit_seconds,
                     objective=objective(fitted.W, fitted.b),
                     exact_objective=objective(W, b),
                     exact_seconds=exact_seconds)
    timit_lsq["objective_over_exact"] = (
        timit_lsq["objective"] / timit_lsq["exact_objective"] - 1.0)
    del X, Y, data, labels, W, b, model, fitted, tm_train
    torch.cuda.empty_cache()

    # Amazon's training CSR against the -1/+1 indicators of its labels
    Xa = amazon["train"]
    Ya = Dataset(2.0 * torch.nn.functional.one_hot(torch.as_tensor(
        amazon["train_labels"], device=dev), 2).float() - 1.0)
    amazon_lse = LeastSquaresEstimator(lam=AMAZON_LSQ_LAM)
    opt_seconds, solver = timed_s(
        lambda: amazon_lse.optimize(Xa, Ya, Xa.per_shard_count))
    solver.fit(Xa, Ya)  # warm
    am_seconds, am_model = timed_s(lambda: solver.fit(Xa, Ya))
    am_objective = lsq_objective64(Xa.matrix, Ya.array, am_model.W,
                                   am_model.b, AMAZON_LSQ_LAM)
    pred_seconds, scores = timed_s(
        lambda: am_model.apply_batch(amazon["test"]).array)
    am_error = float(np.mean(scores.argmax(1).cpu().numpy()
                             != amazon["test_labels"]))
    amazon_lsq = dict(
        n=Xa.count, d=Xa.dim, nnz=Xa.nnz, k=2, lam=AMAZON_LSQ_LAM,
        chosen=amazon_lse.chosen, costs_seconds=amazon_lse.costs,
        sparse_route=getattr(solver, "route", None),
        optimize_seconds=opt_seconds, fit_seconds=am_seconds,
        objective=am_objective, jax_cpu_objective=AMAZON_LSQ_JAX_OBJECTIVE,
        objective_rel_gap=am_objective / AMAZON_LSQ_JAX_OBJECTIVE - 1.0,
        loss_history_first_last=[float(solver.loss_history[0]),
                                 float(solver.loss_history[-1])],
        predict_seconds=pred_seconds, test_docs=amazon["test"].count,
        test_error=am_error, jax_cpu_test_error=AMAZON_LSQ_JAX_TEST_ERROR)

    # the reference suite's sparse shape, both routes forced
    rng = np.random.default_rng(0)
    counts = rng.binomial(SPARSE_D, SPARSE_DENSITY, size=SPARSE_N)
    nnz = int(counts.sum())
    Xs = sp.csr_matrix((rng.standard_normal(nnz).astype(np.float32),
                        rng.integers(0, SPARSE_D, size=nnz),
                        np.concatenate([[0], np.cumsum(counts)])),
                       shape=(SPARSE_N, SPARSE_D))
    Xs.sum_duplicates()
    W_true = rng.standard_normal((SPARSE_D, SPARSE_K)).astype(np.float32)
    Ys = (Xs @ W_true + 0.1 * rng.standard_normal(
        (SPARSE_N, SPARSE_K))).astype(np.float32)
    sdata, slabels = SparseDataset(Xs, device=dev), Dataset(Ys, device=dev)
    sdata.csr(), sdata.csr_t()  # the copies, outside the clocks
    routes, models = {}, {}
    for method in ("gram", "iterative"):
        est = SparseLBFGSwithL2(lam=SPARSE_LAM, num_iters=SPARSE_ITERS,
                                method=method)
        est.fit(sdata, slabels)  # warm
        seconds, m = timed_s(lambda: est.fit(sdata, slabels))
        models[method] = m
        routes[method] = dict(seconds=seconds, objective=lsq_objective64(
            Xs, slabels.array, m.W, m.b, SPARSE_LAM),
            loss_history_first_last=[float(est.loss_history[0]),
                                     float(est.loss_history[-1])])
    Wg, Wi = models["gram"].W, models["iterative"].W
    routes_w_rel = float((Wg - Wi).abs().max() / Wg.abs().max())
    auto = SparseLBFGSwithL2(lam=SPARSE_LAM, num_iters=SPARSE_ITERS)
    mean_width = math.ceil(Xs.nnz / SPARSE_N)
    est_gram, est_iter = auto.route_seconds(SPARSE_N, SPARSE_D, SPARSE_K,
                                            mean_width)
    pad_seconds, padded = timed_s(
        lambda: PaddedSparseDataset.from_csr(Xs, device=dev))
    pest = SparseLBFGSwithL2(lam=SPARSE_LAM, num_iters=SPARSE_ITERS,
                             method="iterative")
    pest.fit(padded, slabels)  # warm
    pfit_seconds, pm = timed_s(lambda: pest.fit(padded, slabels))
    padded_w_rel = float((pm.W - Wi).abs().max() / Wi.abs().max())
    sparse = dict(
        n=SPARSE_N, d=SPARSE_D, k=SPARSE_K, density=SPARSE_DENSITY,
        nnz=Xs.nnz, lam=SPARSE_LAM, num_iters=SPARSE_ITERS,
        reduced="n cut from the reference suite's 5,000,000 to 200,000",
        routes=routes, routes_w_rel_diff=routes_w_rel,
        auto_route=auto._route(SPARSE_N, SPARSE_D, SPARSE_K, mean_width),
        auto_estimate_seconds=dict(gram=est_gram, iterative=est_iter),
        padded=dict(from_csr_seconds=pad_seconds, bytes=padded.nbytes,
                    width=padded.width,
                    column_width=(padded.cidx.shape[1]
                                  if padded.cidx is not None else None),
                    fit_seconds=pfit_seconds,
                    objective=lsq_objective64(Xs, slabels.array, pm.W,
                                              pm.b, SPARSE_LAM),
                    w_rel_diff_from_csr=padded_w_rel))
    launches = launch_counts()
    phase("least_squares", calibration=calibration, timit=timit_lsq,
          amazon=amazon_lsq, sparse=sparse, launches=launches, card=card)
    check(timit_lsq["objective_over_exact"] >= LSQ_EXACT_FLOOR,
          f"the chosen solver's TIMIT objective is below the exact one: "
          f"{timit_lsq}")
    check(amazon_lsq["chosen"] == "sparse-lbfgs"
          and amazon_lsq["sparse_route"] == "iterative",
          f"Amazon's least squares chose {amazon_lsq['chosen']} "
          f"({amazon_lsq['sparse_route']})")
    check(abs(amazon_lsq["objective_rel_gap"]) <= AMAZON_LSQ_RTOL,
          f"Amazon's least-squares objective {am_objective} is not within "
          f"{AMAZON_LSQ_RTOL} of JAX's {AMAZON_LSQ_JAX_OBJECTIVE}")
    check(routes_w_rel <= SPARSE_ROUTES_RTOL, f"the Gram and sparse-product "
          f"routes' W differ by {routes_w_rel} of max|W|")
    check(padded_w_rel <= PADDED_RTOL, f"the padded rows' fit differs from "
          f"the CSR's by {padded_w_rel} of max|W|")
    check(not any(launches.values()),
          f"the least-squares phase launched kernels: {launches}")


def hog_daisy_phase(dev, card) -> None:
    """Phase 22: HOG and DAISY on a batch of gray images."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.images.descriptors import (
        DaisyExtractor,
        HogExtractor,
    )
    from keystone_tpu_torch.ops import kernels

    kernels.reset_launches()
    imgs = np.random.default_rng(0).random(
        (DESC_N, DESC_SIDE, DESC_SIDE)).astype(np.float32)
    out = {}
    for name, ext, x in (("hog", HogExtractor(), imgs[..., None]),
                         ("daisy", DaisyExtractor(), imgs)):
        data = Dataset(x, device=dev)
        ext.apply_batch(data)  # warm
        seconds, got = timed_s(lambda: ext.apply_batch(data).array)
        want = ext.apply_batch(Dataset(x[:DESC_CPU_CHECK],
                                       device="cpu")).array
        rel = float((got[:DESC_CPU_CHECK].cpu() - want).abs().max()
                    / want.abs().max())
        out[name] = dict(seconds=seconds, images_per_sec=DESC_N / seconds,
                         shape=list(got.shape), cpu_check_images=DESC_CPU_CHECK,
                         cpu_rel_diff=rel, tolerance=DESC_RTOL)
    launches = launch_counts()
    phase("hog_daisy", images=DESC_N, side=DESC_SIDE, **out,
          launches=launches, card=card)
    for name, r in out.items():
        check(r["cpu_rel_diff"] <= DESC_RTOL, f"{name} on the card differs "
              f"from the CPU path by {r['cpu_rel_diff']} of max|value|")
    check(not any(launches.values()),
          f"HOG and DAISY launched kernels: {launches}")


def runtime_phase(dev, train, test, config, card) -> dict:
    """Phase 23: the workflow runtime at full width (see the module
    docstring); returns K1's and K4's launches in its measured applies."""
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.nodes.util.fusion import (
        FusedBatchTransformer,
        MegafusedBatchTransformer,
    )
    from keystone_tpu_torch.ops import chain_kernels, kernels
    from keystone_tpu_torch.pipelines import voc_sift_fisher
    from keystone_tpu_torch.pipelines.cifar_variants import (
        LINEAR_PIXELS_MICROBATCH,
        LinearPixelsConfig,
        build_linear_pixels,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import build_pipeline
    from keystone_tpu_torch.telemetry import counter, gauge
    from keystone_tpu_torch.utils import batching
    from keystone_tpu_torch.workflow import FittedPipeline, PipelineEnv
    from keystone_tpu_torch.workflow.env import (
        config_override,
        dispatch_override,
        execution_config,
        overlap_override,
        resolved_chunk_size,
    )
    from keystone_tpu_torch.workflow.executor import (
        GraphExecutor,
        drain_warmups,
    )
    from keystone_tpu_torch.workflow.graph import Graph
    from keystone_tpu_torch.workflow.operators import (
        GatherTransformerOperator,
    )
    from keystone_tpu_torch.workflow.pipeline import (
        PipelineDataset,
        _bind,
        _splice_result,
    )

    def count(name):
        return counter(name).value

    failures_before = count("dispatch.warmup_failures")
    x_test = test.data.array

    # ---- RandomPatchCifar: fit, save, load, with megafusion on and off
    plan_labels = [op.label for op in build_pipeline(train, config)(
        test.data).executor.optimized_graph.operators.values()]
    PipelineEnv.reset()
    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mega in (True, False):
            with config_override(megafusion=mega):
                fitted = build_pipeline(train, config).fit()
            path = os.path.join(tmp, f"rpc_{mega}.pkl")
            fitted.save(path)
            loaded[mega] = FittedPipeline.load(path, device=dev)
            del fitted
            PipelineEnv.reset()
    ops_on = list(loaded[True].graph.operators.values())
    ops_off = list(loaded[False].graph.operators.values())
    mega_op = ops_on[0]
    # what one capture of the apply's graph costs: a fresh copy of the
    # megafused chain warmed up (an eager run, then the capture)
    fresh = MegafusedBatchTransformer(mega_op.stages,
                                      microbatch=mega_op.microbatch)
    capture_seconds, _ = timed_s(lambda: fresh.warmup(
        tuple(x_test.shape[1:]), x_test.dtype, test.data.count, dev))
    del fresh
    # the first apply after the executor's warm-up (off by default, on
    # here as a server would turn it on): its graph is captured
    g, cls = _bind(loaded[True].graph, loaded[True].source, test.data)
    result = cls(GraphExecutor(g, optimize=False), loaded[True].sink)
    captures0 = count("megafusion.graph_captures")
    with config_override(aot_warmup=True):
        expr = result.executor.execute(result.sink)
    drain_warmups()
    torch.cuda.synchronize()
    warm_captures = count("megafusion.graph_captures") - captures0
    kernels.reset_launches()
    replays0 = count("megafusion.graph_replays")
    captures0 = count("megafusion.graph_captures")
    first_seconds, first = timed_s(lambda: expr.get)
    first_k1 = kernels.conv_rectify_pool.launches
    first_replays = count("megafusion.graph_replays") - replays0
    first_captures = count("megafusion.graph_captures") - captures0
    kernels.reset_launches()
    replays0 = count("megafusion.graph_replays")
    captures0 = count("megafusion.graph_captures")
    second_seconds, second = timed_s(lambda: loaded[True].apply(test.data))
    second_k1 = kernels.conv_rectify_pool.launches
    second_replays = count("megafusion.graph_replays") - replays0
    second_captures = count("megafusion.graph_captures") - captures0
    loaded[False].apply(test.data)  # warm
    apply_seconds = {True: [], False: []}
    for mega in (True, False, False, True):
        with config_override(megafusion=mega):
            seconds, out = timed_s(lambda: loaded[mega].apply(test.data))
        apply_seconds[mega].append(seconds)
        if not mega:
            off_predictions = out.array
    _, apply_sync_count = count_syncs(lambda: loaded[True].apply(test.data))
    predictions_equal = bool(torch.equal(second.array, off_predictions)
                             and torch.equal(first.array, second.array))
    # the scores: the megafused chain without its argmax against the
    # unmegafused featurizer and fused head without theirs
    featurizer_off = [op for op in ops_off
                      if isinstance(op, FusedBatchTransformer)][0]
    head_off = [op for op in ops_off
                if isinstance(op, FusedBatchTransformer)][-1]
    # the third call replays (the first runs eagerly, the second captures,
    # counted as one cold compile)
    scores_fn = MegafusedBatchTransformer(
        mega_op.stages[:-1], microbatch=mega_op.microbatch).batch_fn()
    compiled_by_call = []
    for _ in range(3):
        compiled0 = count("dispatch.programs_compiled")
        scores_on = scores_fn(x_test)
        compiled_by_call.append(count("dispatch.programs_compiled")
                                - compiled0)
    scores_off = FusedBatchTransformer(
        head_off.stages[:-1], microbatch=head_off.microbatch).batch_fn()(
            featurizer_off.batch_fn()(x_test))
    score_rel = float((scores_on - scores_off).abs().max()
                      / scores_off.abs().max())
    del scores_on, scores_off, loaded, expr, result, first, second
    torch.cuda.empty_cache()

    # ---- LinearPixels: the head as one replay against 25 microbatches
    PipelineEnv.reset()
    lp = build_linear_pixels(train, LinearPixelsConfig())
    pixels = cut(lp, 2)(train.data).get().array
    model = lp.fitted(0)
    lp_head = {}
    for name, head in (
            ("megafused", MegafusedBatchTransformer([model, MaxClassifier()])),
            ("microbatches_2048", FusedBatchTransformer(
                [model, MaxClassifier()], microbatch=2048))):
        fn = head.batch_fn()
        lp_head[name] = dict(ms=time_ms(lambda: fn(pixels)))
    lp_head["equal"] = bool(torch.equal(
        MegafusedBatchTransformer([model, MaxClassifier()]).batch_fn()(
            pixels), FusedBatchTransformer(
                [model, MaxClassifier()], microbatch=2048).batch_fn()(pixels)))
    for _ in range(2):  # its first call runs eagerly, the second captures
        lp(test.data).get()
    kernels.reset_launches()
    lp_apply_seconds, _ = timed_s(lambda: lp(test.data).get())
    lp_k4 = chain_kernels.elementwise_chain.launches
    lp_labels = [op.label for op in lp(test.data).executor
                 .optimized_graph.operators.values()]
    del lp, pixels, model
    # what each knob costs a whole LinearPixels run (build, fit, predict
    # the training rows): the default, each knob flipped from it, all off
    # (the dispatch before the runtime), in order and then in reverse
    knobs = dict(default={}, dispatch_on=dict(concurrent_dispatch=True),
                 warmup_on=dict(aot_warmup=True),
                 overlap_off=dict(overlap=False),
                 megafusion_off=dict(megafusion=False),
                 all_off=dict(concurrent_dispatch=False, aot_warmup=False,
                              overlap=False, megafusion=False))
    knob_seconds = {name: [] for name in knobs}
    for order in (list(knobs), list(knobs)[::-1]):
        for name in order:
            PipelineEnv.reset()
            with config_override(**knobs[name]):
                seconds, _ = timed_s(lambda: build_linear_pixels(
                    train, LinearPixelsConfig())(train.data).get())
            drain_warmups()
            knob_seconds[name].append(seconds)
    PipelineEnv.reset()
    torch.cuda.empty_cache()

    # ---- VOC's featurization, overlap off and on
    vc_config = voc_sift_fisher.VOCSIFTFisherConfig(
        num_classes=VOC_CLASSES, pca_dims=VOC_PCA_DIMS, gmm_k=VOC_GMM_K)
    vc_train = voc_sift_fisher._synthetic_voc(VOC_N_TRAIN, VOC_CLASSES,
                                              vc_config.seed)
    vc_test = voc_sift_fisher._synthetic_voc(VOC_N_TEST, VOC_CLASSES,
                                             vc_config.seed + 1)
    vc_tr = HostDataset(vc_train.items, device=dev)
    vc_te = HostDataset(vc_test.items, device=dev)
    depth = execution_config().prefetch_depth
    chunk = resolved_chunk_size()
    image = np.asarray(vc_train.items[0].image)
    chunk_bytes = chunk * image.nbytes
    # a megafused group is one unit of the ring: its chunks, at most
    # batching._MEGAFUSED_MAX_TRIPS of them, in each of depth + 1 buffers
    group_bound = (depth + 1) * min(batching._MEGAFUSED_MAX_TRIPS, math.ceil(
        len(vc_train) / chunk)) * chunk_bytes

    def sift_of(data):
        PipelineEnv.reset()
        model = voc_sift_fisher.build(data, vc_config, dev)
        return model.sift(data).get()

    def buckets_equal(a, b):
        return a.count == b.count and all(
            torch.equal(x, y) for x, y in zip(a.items, b.items))

    # megafusion off: the gray chain's chunks one by one; the default:
    # a bucket's chunks as one megafused group, staged as one unit
    overlap = {mega: {on: dict(seconds=[], peak_pinned_bytes=[])
                      for on in (False, True)} for mega in (False, True)}
    outs = {}
    for mega in (False, True):
        with config_override(megafusion=mega):
            sift_of(HostDataset(vc_train.items[:SIFT_FISHER_WARM],
                                device=dev))
            for on in (False, True, True, False):
                pinned = gauge("overlap.peak_pinned_bytes")
                pinned.reset()
                with overlap_override(on):
                    seconds, outs[mega, on] = timed_s(lambda: sift_of(vc_tr))
                overlap[mega][on]["seconds"].append(seconds)
                overlap[mega][on]["peak_pinned_bytes"].append(pinned.max)
    overlap_equal = all(buckets_equal(outs[False, False], outs[key])
                        for key in outs)
    del outs
    torch.cuda.empty_cache()

    # ---- the scheduler: train and test featurization as two branches
    def both():
        PipelineEnv.reset()
        model = voc_sift_fisher.build(vc_tr, vc_config, dev)
        g = Graph()
        g, a = _splice_result(g, model.sift(vc_tr))
        g, b = _splice_result(g, model.sift(vc_te))
        g, gid = g.add_node(GatherTransformerOperator(), [a, b])
        g, sink = g.add_sink(gid)
        return PipelineDataset(GraphExecutor(g), sink).get()

    runs_before = count("dispatch.scheduler_runs")
    sched = {4: [], 1: []}
    outs = {}
    for workers in (4, 1, 1, 4):
        with dispatch_override(True, workers=workers):
            seconds, outs[workers] = timed_s(both)
        sched[workers].append(seconds)
    sched_equal = all(buckets_equal(p, q) for p, q in zip(
        outs[4].parts, outs[1].parts))
    sched_runs = count("dispatch.scheduler_runs") - runs_before
    del outs, vc_tr, vc_te
    PipelineEnv.reset()
    torch.cuda.empty_cache()
    drain_warmups()
    warmup_failures = count("dispatch.warmup_failures") - failures_before

    phase("runtime", config=dict(
              overlap=execution_config().overlap, prefetch_depth=depth,
              concurrent_dispatch=execution_config().concurrent_dispatch,
              dispatch_workers=execution_config().dispatch_workers,
              chunk_size=chunk, pad_chunks=execution_config().pad_chunks,
              aot_warmup=execution_config().aot_warmup,
              megafusion=execution_config().megafusion),
          random_patch_cifar=dict(
              plan_labels=plan_labels, fitted_on=[op.label for op in ops_on],
              fitted_off=[op.label for op in ops_off],
              trip_rows=mega_op.microbatch, rung_rows=mega_op.rung(
                  test.data.count),
              warm_up_captures=warm_captures,
              capture_seconds=capture_seconds,
              first_apply=dict(seconds=first_seconds, replays=first_replays,
                               captures=first_captures, k1=first_k1),
              second_apply=dict(seconds=second_seconds,
                                replays=second_replays,
                                captures=second_captures, k1=second_k1),
              apply_seconds_on=apply_seconds[True],
              apply_seconds_off=apply_seconds[False],
              apply_syncs=apply_sync_count,
              predictions_equal=predictions_equal,
              score_rel_diff=score_rel,
              compiles_by_call_at_a_rung=compiled_by_call),
          linear_pixels=dict(head_over_train_rows=lp_head,
                             test_apply_seconds=lp_apply_seconds,
                             test_apply_k4=lp_k4, plan_labels=lp_labels,
                             run_seconds_by_knob=knob_seconds),
          voc_overlap=dict(images=len(vc_train), chunk_bytes=chunk_bytes,
                           pinned_bound_bytes=(2 * depth + 2) * chunk_bytes,
                           megafusion_off=dict(off=overlap[False][False],
                                               on=overlap[False][True]),
                           default=dict(off=overlap[True][False],
                                        on=overlap[True][True]),
                           group_pinned_bound_bytes=group_bound,
                           equal=overlap_equal),
          scheduler=dict(workers_4=sched[4], workers_1=sched[1],
                         equal=sched_equal, scheduler_runs=sched_runs),
          warmup_failures=warmup_failures, card=card)
    test_mb = math.ceil(test.data.count / config.microbatch)
    check(sum(label.startswith("Megafused[") for label in plan_labels) == 1,
          f"the plan holds no single Megafused node: {plan_labels}")
    check(len(ops_on) == 1 and isinstance(mega_op, MegafusedBatchTransformer),
          f"the fitted pipeline is {[op.label for op in ops_on]}")
    check(warm_captures == 1 and first_captures == 0 and first_replays == 1
          and first_k1 == test_mb, f"the first apply after the warm-up "
          f"captured {first_captures}, replayed {first_replays} and launched "
          f"conv_rectify_pool {first_k1} times (want 0, 1, {test_mb})")
    check(second_captures == 0 and second_replays == 1
          and second_k1 == test_mb, f"the second apply captured "
          f"{second_captures}, replayed {second_replays}, launched "
          f"conv_rectify_pool {second_k1} times")
    check(predictions_equal, "the megafused apply's predictions differ from "
          "the unmegafused apply's")
    check(apply_sync_count == 0, f"the loaded apply made {apply_sync_count} "
          "synchronizing calls (the live plane on)")
    check(compiled_by_call == [0, 1, 0], "the three calls at one rung "
          f"compiled {compiled_by_call} (want one capture, at the second)")
    check(score_rel <= 1e-5, f"the megafused scores are {score_rel} of "
          "max|score| from the unmegafused scores")
    check(lp_head["equal"], "LinearPixels' megafused head disagrees with "
          "its microbatched head")
    check(lp_k4 == math.ceil(test.data.count / LINEAR_PIXELS_MICROBATCH),
          f"LinearPixels' megafused test apply launched the chain kernel "
          f"{lp_k4} times")
    check(overlap_equal, "VOC's descriptors differ with the overlap engine "
          "on and off")
    for mega, bound in ((False, (2 * depth + 2) * chunk_bytes),
                        (True, group_bound)):
        pinned_on = overlap[mega][True]["peak_pinned_bytes"]
        check(max(pinned_on) <= bound and min(pinned_on) > 0
              and max(overlap[mega][False]["peak_pinned_bytes"]) == 0,
              f"pinned bytes {overlap[mega]} (megafusion {mega}) against "
              f"{bound}")
    check(sched_equal and sched_runs >= 2, "the scheduler's outputs at 4 "
          f"workers differ from 1 worker's (or it ran {sched_runs} times)")
    check(warmup_failures == 0, f"{warmup_failures} warm-ups failed")
    return dict(k1=second_k1, k4=lp_k4, compiles_by_call=compiled_by_call)


def without_argmax(pipeline):
    """``pipeline`` ending before its final `MaxClassifier`, if any: its
    scores."""
    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    g = pipeline.graph
    last = g.get_sink_dependency(pipeline.sink)
    if not isinstance(g.get_operator(last), MaxClassifier):
        return pipeline
    return Pipeline(g.set_sink_dependency(pipeline.sink,
                                          g.get_dependencies(last)[0]),
                    pipeline.source, pipeline.sink)


def cpu_path_rel(predictor, test) -> tuple:
    """(the largest gap between the card's scores of ``test`` and the
    port's CPU path's on the card's fitted weights, as a share of
    max|score|; whether their argmax agree): ``predictor``'s scores
    fitted, saved, and loaded on the CPU."""
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.workflow import FittedPipeline

    fitted = without_argmax(predictor).fit()
    card_scores = fitted.apply(test).array.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fitted.pkl")
        fitted.save(path)
        on_cpu = FittedPipeline.load(path, device="cpu")
    items = [type(x)(*[v.cpu() if isinstance(v, torch.Tensor) else v
                       for v in vars(x).values()]) for x in test.items]
    cpu_scores = on_cpu.apply(HostDataset(items, device="cpu")).numpy()
    rel = float(np.abs(cpu_scores - card_scores).max()
                / np.abs(card_scores).max())
    return rel, bool((cpu_scores.argmax(1) == card_scores.argmax(1)).all())


def loaders_phase(dev, card) -> dict:
    """Phase 24: the image loaders (see the module docstring); returns
    the K4 launches of VOCSIFTFisher from the 1,000-image tar."""
    import hashlib
    import tarfile

    from keystone_tpu_torch.loaders import imagenet_loader, voc_loader
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import (
        imagenet_sift_lcs_fv,
        voc_sift_fisher,
    )
    from keystone_tpu_torch.utils import native_io
    from keystone_tpu_torch.workflow import PipelineEnv

    def digest(img):
        u = img.to(torch.uint8).cpu().numpy()
        return (tuple(u.shape), int(u.astype(np.int64).sum()),
                hashlib.sha256(u.tobytes()).hexdigest()[:16])

    # the committed images, decoded onto the card
    decoded, mismatched = {}, []
    for archive, pins in DECODE_PINS.items():
        with open(os.path.join(RES_DIR, archive), "rb") as f:
            buf = f.read()
        if archive.endswith(".tar"):
            index = native_io.tar_index(buf)
            names = [n for n, _, _ in index]
            entries = [(o, s) for _, o, s in index]
        else:
            names, entries = [archive], [(0, len(buf))]
        images, ok = native_io.decode_jpeg_batch(buf, entries, dev)
        check(ok == len(pins) and names == [p[0] for p in pins],
              f"{archive}: decoded {ok} of {names}")
        for (name, shape, total, sha), img in zip(pins, images):
            check(img.device.type == "cuda" and img.dtype == torch.float32,
                  f"{archive}/{name} decoded to {img.device} {img.dtype}")
            got = digest(img)
            decoded[f"{archive}/{name}"] = dict(sum=got[1], sha256_16=got[2])
            if got != (shape, total, sha):
                mismatched.append(f"{archive}/{name}: {got} against "
                                  f"{(shape, total, sha)}")
    voc_mini = voc_loader(os.path.join(RES_DIR, VOC_MINI),
                          os.path.join(RES_DIR, VOC_MINI_CSV), device=dev)
    voc_rows = [(os.path.basename(x.filename), list(x.labels))
                for x in voc_mini.items]
    im_mini = imagenet_loader(os.path.join(RES_DIR, IMAGENET_MINI),
                              IMAGENET_MINI_LABELS, device=dev)
    im_rows = [x.label for x in im_mini.items]

    # 1,000 copies of a real VOC 2007 image, with a labels CSV
    with open(os.path.join(RES_DIR, JPEG_12), "rb") as f:
        jpeg = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        big_tar = os.path.join(tmp, "voc_1000.tar")
        big_csv = os.path.join(tmp, "voc_1000_labels.csv")
        with tarfile.open(big_tar, "w", format=tarfile.USTAR_FORMAT) as tar:
            for i in range(BIG_TAR_N):
                info = tarfile.TarInfo(f"JPEGImages/{i:06d}.jpg")
                info.size = len(jpeg)
                tar.addfile(info, io.BytesIO(jpeg))
        with open(big_csv, "w") as f:
            f.writelines(f"{i:06d}.jpg,{i % VOC_CLASSES}\n"
                         for i in range(BIG_TAR_N))
        voc_loader(big_tar, big_csv, max_images=8, device=dev)  # warm
        load_seconds, big = timed_s(lambda: voc_loader(big_tar, big_csv,
                                                       device=dev))
        big_pixels = sum(int(np.prod(x.image.shape)) for x in big.items)
        big_ok = len(big) == BIG_TAR_N and all(
            digest(x.image)[1:] == DECODE_PINS[JPEG_12][0][2:]
            for x in big.items[::97])
        del big
        # VOCSIFTFisher at the reference's widths from that tar
        big_config = voc_sift_fisher.VOCSIFTFisherConfig(
            train_tar=big_tar, train_labels=big_csv, test_tar=big_tar,
            test_labels=big_csv, num_classes=VOC_CLASSES,
            pca_dims=VOC_PCA_DIMS, gmm_k=VOC_GMM_K)
        PipelineEnv.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        vb = voc_sift_fisher.run(big_config, dev)
        vb_total = time.perf_counter() - t0
        vb_peak = torch.cuda.max_memory_allocated()
        vb_launches = launch_counts()
        vb_features = vb["model"].predictor.fitted().W.shape[0]
        del vb["model"], vb["scores"]
        PipelineEnv.reset()
        torch.cuda.empty_cache()
        vb_syncs, vb_sync_count = count_syncs(
            lambda: voc_sift_fisher.run(big_config, dev))
        PipelineEnv.reset()
        torch.cuda.empty_cache()

    # both pipelines end to end from the mini tars, at small widths
    vm_config = voc_sift_fisher.VOCSIFTFisherConfig(
        train_tar=os.path.join(RES_DIR, VOC_MINI),
        train_labels=os.path.join(RES_DIR, VOC_MINI_CSV),
        num_classes=VOC_CLASSES, pca_dims=MINI_PCA_DIMS, gmm_k=MINI_GMM_K)
    vm = voc_sift_fisher.run(vm_config, dev)
    vm_rel, vm_argmax = cpu_path_rel(vm["model"].predictor, voc_mini)
    PipelineEnv.reset()
    with tempfile.TemporaryDirectory() as tmp:
        labels_map = os.path.join(tmp, "labels_map.csv")
        with open(labels_map, "w") as f:
            f.writelines(f"{k},{v}\n"
                         for k, v in IMAGENET_MINI_LABELS.items())
        im_config = imagenet_sift_lcs_fv.ImageNetSiftLcsFVConfig(
            train_tar=os.path.join(RES_DIR, IMAGENET_MINI),
            labels_map_csv=labels_map,
            num_classes=len(IMAGENET_MINI_LABELS), pca_dims=MINI_PCA_DIMS,
            gmm_k=MINI_GMM_K)
        im = imagenet_sift_lcs_fv.run(im_config, dev)
    im_rel, im_argmax = cpu_path_rel(im["predictor"], im_mini)
    PipelineEnv.reset()
    torch.cuda.empty_cache()

    phase("loaders", decoder="port baseline decoder (csrc/jpeg_baseline.cpp)"
          " on the host, images copied to the card; the machine has no "
          "libjpeg", pixels_case="exact" if not mismatched else "mismatch",
          decoded=decoded, mismatched=mismatched, voc_mini_rows=voc_rows,
          imagenet_mini_labels=im_rows,
          big_tar=dict(images=BIG_TAR_N, source=JPEG_12,
                       cut="VOC 2007's 5,011 training images cut to 1,000",
                       load_seconds=load_seconds,
                       images_per_sec=BIG_TAR_N / load_seconds,
                       decode_threads=native_io.decode_threads(),
                       host_bytes_uint8=big_pixels,
                       device_bytes_float32=4 * big_pixels,
                       pixels_equal_pins=big_ok),
          voc_big=dict(seconds=vb["seconds"], seconds_with_loading=vb_total,
                       images_per_sec=vb["images_per_sec"],
                       features=vb_features, peak_mem_bytes=vb_peak,
                       launches=vb_launches,
                       k4_launches=vb_launches["elementwise_chain"],
                       syncs=vb_sync_count, sync_lines=vb_syncs,
                       mean_average_precision_not_held=vb["map"]),
          voc_mini=dict(seconds=vm["seconds"], map=vm["map"],
                        cpu_score_rel_diff=vm_rel,
                        cpu_argmax_equal=vm_argmax),
          imagenet_mini=dict(seconds=im["seconds"],
                             test_accuracy=im["test_accuracy"],
                             cpu_score_rel_diff=im_rel,
                             cpu_argmax_equal=im_argmax),
          card=card)
    check(not mismatched, f"decoded pixels differ from the pins: "
          f"{mismatched}")
    check(voc_rows == VOC_MINI_ROWS, f"voc_loader gave {voc_rows}")
    check(im_rows == IMAGENET_MINI_ROWS, f"imagenet_loader gave {im_rows}")
    check(big_ok, "the 1,000-image tar did not decode to 000012.jpg's "
          "pinned pixels")
    check(vb_features == 2 * VOC_PCA_DIMS * VOC_GMM_K,
          f"VOCSIFTFisher from the tar has {vb_features} features")
    check(vb_launches["elementwise_chain"] > 0, "VOCSIFTFisher from the tar "
          "launched no chain kernel")
    for name, rel, argmax in (("VOCSIFTFisher", vm_rel, vm_argmax),
                              ("ImageNetSiftLcsFV", im_rel, im_argmax)):
        check(argmax and rel <= VOC_CPU_SCORE_RTOL, f"{name} from the mini "
              f"tar: the CPU path's scores are {rel} of max|score| from the "
              f"card's (argmax equal: {argmax})")
    return dict(voc_big_k4=vb_launches["elementwise_chain"])


def telemetry_phase(dev, train, test, config, card, compiles_after_build,
                    runtime) -> int:
    """Phase 25: the telemetry layer on the card (see the module
    docstring); returns K1's launches in the traced run."""
    from keystone_tpu_torch import telemetry
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.ops import _build, kernels
    from keystone_tpu_torch.pipelines.cifar_variants import (
        LinearPixelsConfig,
        build_linear_pixels,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import build_pipeline
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.env import config_override

    def rpc_run():
        PipelineEnv.reset()
        return build_pipeline(train, config)(test.data).get()

    def lp_run():
        PipelineEnv.reset()
        return build_linear_pixels(train, LinearPixelsConfig())(
            train.data).get()

    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "rpc.json")
        ledger_path = os.path.join(tmp, "rpc.ledger.jsonl")

        def counted(traced: bool):
            """(syncs, K1 launches, programs executed, predictions)."""
            kernels.reset_launches()
            out = []
            with telemetry.metrics_delta() as delta:
                if traced:
                    with config_override(ledger_path=ledger_path), \
                            telemetry.trace_run(trace_path):
                        _, syncs = count_syncs(lambda: out.append(rpc_run()))
                else:
                    _, syncs = count_syncs(lambda: out.append(rpc_run()))
            return (syncs, kernels.conv_rectify_pool.launches,
                    delta.counter("dispatch.programs_executed"),
                    out[0].array)

        rpc_run()  # warm
        plain = counted(False)
        traced = counted(True)
        trace = telemetry.load_trace(trace_path)
        decisions = ledger.read_ledger(ledger_path)["decisions"]
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        cats = sorted({e.get("cat") for e in events})
        orphans = [e["name"] for e in events if e.get("cat") in (
            "phase", "node", "chunk", "step")
            and "parent_id" not in e["args"]]
        run_us = max(e["dur"] for e in events if e.get("cat") == "pipeline")
        node_self_s = sum(a["self_s"] for a in telemetry.aggregate_spans(
            trace, "node").values())
        by_cat = collections.Counter(e.get("cat") for e in events)
        # traced against untraced, alternating
        pairs = {}
        for name, fn in (("random_patch_cifar", rpc_run),
                         ("linear_pixels", lp_run)):
            fn()  # warm
            times = dict(traced=[], untraced=[])
            for i in range(2 * TRACE_PAIRS):
                traced_now = (i % 4) in (0, 3)
                if traced_now:
                    with telemetry.trace_run():
                        seconds, _ = timed_s(fn)
                else:
                    seconds, _ = timed_s(fn)
                times["traced" if traced_now else "untraced"].append(seconds)
            pairs[name] = times
        PipelineEnv.reset()

        # the ledger: a fitted LinearPixels applied, megafusion on then off
        ledgers = {}
        for mega in (True, False):
            PipelineEnv.reset()
            ledger.clear_session()
            path = os.path.join(tmp, f"lp_mega_{int(mega)}.jsonl")
            with config_override(megafusion=mega, ledger_path=path):
                build_linear_pixels(train, LinearPixelsConfig()).fit().apply(
                    test.data)
            ledgers[mega] = ledger.read_ledger(path)
        diff = ledger.diff_runs(ledgers[True], ledgers[False])
        flips = [f["env"] for f in diff["config_flips"]]
        PipelineEnv.reset()

        # the flight recorder: every request so far went through its ring
        recorder = telemetry.ensure_flight()
        dump = telemetry.flight_snapshot(os.path.join(tmp, "flight.json"))
        flight = telemetry.load_trace(dump)
        flight_spans = sum(1 for e in flight["traceEvents"]
                           if e.get("ph") == "X")
        flight_meta = flight["keystone"]["flight"]

    # 200 requests of 64 images to a fitted LinearPixels, live plane off
    # and on
    fitted = build_linear_pixels(train, LinearPixelsConfig()).fit()
    x = test.data.array
    span_rows = x.shape[0] - REQUEST_ROWS + 1
    requests = [Dataset(x[s:s + REQUEST_ROWS]) for s in (
        (i * REQUEST_ROWS) % span_rows for i in range(REQUESTS))]

    def serve():
        for d in requests:
            fitted.apply(d)

    for _ in range(3):  # its rung's eager call, capture, replay
        fitted.apply(requests[0])
    request_seconds = dict(live_off=[], live_on=[])
    for live in (False, True, True, False):
        telemetry.reset_live()
        with config_override(live_telemetry=live):
            seconds, _ = timed_s(serve)
        request_seconds["live_on" if live else "live_off"].append(seconds)
        if live:
            live_health = telemetry.health()
    _, request_syncs = count_syncs(serve)
    latency = [dict(pipeline=r["pipeline"], chunk_shape=r["chunk_shape"],
                    count=r["count"], p50_s=r["p50"], p99_s=r["p99"],
                    max_s=r["max"]) for r in live_health["latency"]]
    del fitted, requests
    PipelineEnv.reset()
    compiles = telemetry.compiles_snapshot()

    phase("telemetry",
          random_patch_cifar=dict(
              categories=cats, spans_by_category=dict(by_cat),
              spans_without_parent=orphans, run_seconds=run_us / 1e6,
              node_self_seconds=node_self_s,
              syncs=dict(untraced=plain[0], traced=traced[0]),
              k1=dict(untraced=plain[1], traced=traced[1]),
              programs_executed=dict(untraced=plain[2], traced=traced[2]),
              decisions=sorted({ledger.decision_key(d)[0]
                                for d in decisions}),
              predictions_equal=bool(torch.equal(plain[3], traced[3]))),
          traced_vs_untraced_seconds=pairs,
          ledger_diff=dict(config_flips=flips,
                           decisions_removed=diff["decisions_removed"],
                           text=ledger.format_diff(diff)),
          compiles=dict(after_build=compiles_after_build, at_end=compiles,
                        runtime_rung_calls=runtime["compiles_by_call"]),
          flight=dict(spans=flight_spans, **flight_meta,
                      capacity_env=recorder.capacity),
          requests=dict(count=REQUESTS, rows=REQUEST_ROWS,
                        seconds=request_seconds, syncs=request_syncs,
                        health_latency=latency,
                        throughput_rps=live_health["throughput_rps"]),
          card=card)
    need = {"pipeline", "phase", "node", "chunk", "step"}
    check(need <= set(cats), f"the trace's categories are {cats}")
    check(not orphans, f"spans without a parent: {orphans[:5]}")
    check(node_self_s * 1e6 <= run_us, f"node self-times {node_self_s} s "
          f"exceed the run's {run_us / 1e6} s")
    check(plain[0] == traced[0] and plain[1] == traced[1] == 30
          and plain[2] == traced[2], "traced against untraced: syncs "
          f"{plain[0]}/{traced[0]}, K1 {plain[1]}/{traced[1]}, programs "
          f"{plain[2]}/{traced[2]}")
    check(torch.equal(plain[3], traced[3]), "the traced run's predictions "
          "differ from the untraced run's")
    check("KEYSTONE_MEGAFUSION" in flips, f"diff_runs named {flips}")
    check(compiles_after_build["programs_compiled"] >= len(_build.SOURCES)
          and compiles["programs_compiled"] > compiles_after_build[
              "programs_compiled"] and compiles["compile_cache_hits"] > 0,
          f"compile accounting {compiles_after_build} then {compiles}")
    check(flight_spans <= flight_meta["capacity"]
          and flight_meta["spans_held"] <= flight_meta["capacity"],
          f"the flight dump holds {flight_spans} spans against "
          f"{flight_meta}")
    check(request_syncs == 0, f"200 requests made {request_syncs} "
          "synchronizing calls")
    check(sum(r["count"] for r in latency) == REQUESTS and all(
        r["chunk_shape"] == REQUEST_ROWS for r in latency),
          f"health() holds {latency}")
    return traced[1]


def serving_phase(dev, train, test, config, card) -> dict:
    """Phase 26: certified serving on the card (see the module docstring);
    returns the kernels' launches in the served traffic."""
    from keystone_tpu_torch.analysis import ServingEnvelope
    from keystone_tpu_torch.analysis.examples import EXAMPLES
    from keystone_tpu_torch.analysis.serving import certify_example
    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.ops import chain_kernels, kernels
    from keystone_tpu_torch.pipelines.cifar_variants import (
        LinearPixelsConfig,
        build_linear_pixels,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import build_pipeline
    from keystone_tpu_torch.pipelines.text_pipelines import (
        build_newsgroups_predictor,
        synthetic_corpus,
    )
    from keystone_tpu_torch.serving import (
        AdmissionRefused,
        NdarrayIngress,
        ServingRuntime,
        ShedError,
        TenantRegistry,
        TextIngress,
        split_fitted_at,
    )
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.telemetry import compiles_snapshot, counter
    from keystone_tpu_torch.telemetry import histogram
    from keystone_tpu_torch.telemetry.watchdog import _padded_shape
    from keystone_tpu_torch.utils import graphs
    from keystone_tpu_torch.workflow import FittedPipeline, PipelineEnv
    from keystone_tpu_torch.workflow.env import config_override

    t_phase = time.perf_counter()

    def count(name):
        return counter(name).value

    def cold():
        return compiles_snapshot()["programs_compiled"]

    # ---- the seven examples certified with the card's calibration
    certs = {}
    for ex in EXAMPLES:
        cert, diags = certify_example(ex, device=dev)
        rules = sorted({(d.rule, d.severity.name) for d in diags
                        if d.rule.startswith("KP9")})
        bound = {s["batch"]: s["predicted_seconds"] for s in cert.shapes}
        certs[ex] = dict(certified=cert.certified,
                         rules=[f"{r}:{sev}" for r, sev in rules],
                         bound_ms_1=1e3 * bound[1],
                         bound_ms_64=1e3 * bound[SERVE_MAX_BATCH],
                         dominating_stage=cert.dominating_stage)
        check((cert.certified, [list(r) for r in rules])
              == SERVING_CARD_VERDICTS[ex],
              f"{ex}: certified {cert.certified} with {rules}, the CPU "
              f"tests pin {SERVING_CARD_VERDICTS[ex]}")

    # captures made, and by which thread: a swap must capture on its own
    captured_on = []
    capture_init = graphs.CapturedLoop.__init__

    def recording_init(self, *args, **kwargs):
        captured_on.append(threading.current_thread().name)
        capture_init(self, *args, **kwargs)

    graphs.CapturedLoop.__init__ = recording_init

    def fit_loaded(build, data, tmp, tag, scores=True):
        """``build`` fit on ``data`` (its argmax cut off for ``scores``),
        saved and loaded onto the card."""
        PipelineEnv.reset()
        pipeline = build(data)
        fitted = (without_argmax(pipeline) if scores else pipeline).fit()
        path = os.path.join(tmp, f"{tag}.pkl")
        fitted.save(path)
        del fitted
        PipelineEnv.reset()
        return FittedPipeline.load(path, device=dev)

    def fire(rt, rows, clients, timeout=120.0):
        """``rows`` submitted from ``clients`` threads: (answers, each
        request's seconds, errors)."""
        answers, seconds, errors = {}, {}, []
        todo = list(range(len(rows)))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop()
                t0 = time.perf_counter()
                try:
                    answers[i] = rt.submit(rows[i], timeout=timeout)
                except Exception as e:  # recorded, checked below
                    errors.append((i, repr(e)))
                seconds[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return answers, seconds, errors

    def pct(values, q):
        return float(np.percentile(np.asarray(values), q)) if values else None

    envelope = ServingEnvelope(max_batch=SERVE_MAX_BATCH, slo_seconds=1.0)
    x_img = test.data.array[:SERVE_REQUESTS].cpu().numpy()
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # ---- RandomPatchCifar at full width
            t0 = time.perf_counter()
            rpc = fit_loaded(lambda d: build_pipeline(d, config), train, tmp,
                             "rpc_a")
            shifted = LabeledData(
                Dataset((train.labels.array + 1) % config.num_classes),
                train.data)
            rpc_b = fit_loaded(lambda d: build_pipeline(d, config), shifted,
                               tmp, "rpc_b")
            fit_seconds = time.perf_counter() - t0
            ref = rpc.apply(Dataset(x_img, device=dev)).array.cpu().numpy()
            ref_b = rpc_b.apply(Dataset(x_img, device=dev)).array.cpu().numpy()
            scale = float(np.abs(ref).max())
            rt = ServingRuntime(rpc, NdarrayIngress(x_img.shape[1:]),
                                envelope=envelope, name="RandomPatchCifar",
                                device=dev)
            t0 = time.perf_counter()
            rt.start()
            start_seconds = time.perf_counter() - t0
            start_captures = len(captured_on)
            rungs = {}
            apply_fn = rt._batcher.apply_fn

            def timed(stacked):
                t = time.perf_counter()
                y = apply_fn(stacked)
                rungs.setdefault(_padded_shape(len(stacked)), []).append(
                    time.perf_counter() - t)
                return y

            rt._batcher.apply_fn = timed
            coalesced = histogram("serving.coalesced_batch")
            coalesced.reset()
            kernels.reset_launches()
            before = {n: count(n) for n in (
                "megafusion.graph_captures", "megafusion.graph_replays",
                "kernels.chain_plan_builds", "serving.dispatches",
                "serving.slo_breaches")}
            cold0, captures0 = cold(), len(captured_on)
            t0 = time.perf_counter()
            answers, seconds, errors = fire(rt, x_img, SERVE_CLIENTS)
            serve_seconds = time.perf_counter() - t0
            k1 = kernels.conv_rectify_pool.launches
            delta = {n: count(n) - v for n, v in before.items()}
            check(not errors, f"serving errors: {errors[:3]}")
            got = np.stack([answers[i] for i in range(len(x_img))])
            err = float(np.abs(got - ref).max())
            check(err <= SERVE_SCORE_RTOL * scale,
                  f"served scores differ from the batch apply by {err} "
                  f"(limit {SERVE_SCORE_RTOL} x {scale})")
            check((got.argmax(1) == ref.argmax(1)).all(),
                  "a served class differs from the batch apply's")
            stats = rt.stats()
            check(stats["dispatched_outside_ladder"] == [],
                  f"dispatched off the ladder: {stats}")
            check(delta["megafusion.graph_captures"] == 0
                  and cold() == cold0 and len(captured_on) == captures0,
                  f"captures or cold records after start(): {delta}")
            check(delta["kernels.chain_plan_builds"] == 0,
                  "launch plans built after start()")
            check(delta["megafusion.graph_replays"]
                  == delta["serving.dispatches"] > 0,
                  f"a dispatch that is no replay: {delta}")
            replays = delta["megafusion.graph_replays"]
            check(k1 > 0 and k1 % replays == 0,
                  f"K1 launches {k1} for {replays} replays")
            check(delta["serving.slo_breaches"] == 0,
                  f"the watchdog recorded {delta['serving.slo_breaches']} "
                  "breaches")
            # every rung of the ladder, and two ragged counts, dispatched
            # straight: replays, and no capture
            kernels.reset_launches()
            replays0 = count("megafusion.graph_replays")
            for b in rt.stats()["ladder"] + [3, 11]:
                for _ in range(SERVE_RUNG_REPS):
                    t = time.perf_counter()
                    y = rt._apply_batch(x_img[:b])
                    rungs.setdefault(_padded_shape(b), []).append(
                        time.perf_counter() - t)
                check(np.abs(y - ref[:b]).max() <= SERVE_SCORE_RTOL * scale,
                      f"a {b}-row dispatch differs from the batch apply")
            sweep_replays = count("megafusion.graph_replays") - replays0
            check(count("megafusion.graph_captures")
                  == before["megafusion.graph_captures"]
                  and cold() == cold0
                  and kernels.conv_rectify_pool.launches
                  == sweep_replays * (k1 // max(1, replays)),
                  "the ladder sweep captured, or launched K1 off its replays")
            syncs, n_syncs = count_syncs(
                lambda: rt._apply_batch(x_img[:SERVE_MAX_BATCH]))
            bounds = {s["batch"]: s["predicted_seconds"]
                      for s in rt.certificate.shapes}
            out["rpc"] = dict(
                fit_seconds=fit_seconds, start_seconds=start_seconds,
                start_captures=start_captures,
                warmed_sites=rt.warmed_sites, requests=len(x_img),
                clients=SERVE_CLIENTS, seconds=serve_seconds,
                requests_per_sec=len(x_img) / serve_seconds,
                p50_ms=1e3 * pct(list(seconds.values()), 50),
                p99_ms=1e3 * pct(list(seconds.values()), 99),
                max_abs_err=err, max_abs_score=scale,
                coalesced_batch=coalesced.snapshot(),
                dispatches=delta["serving.dispatches"], replays=replays,
                k1=k1, k1_per_replay=k1 // max(1, replays),
                syncs_per_dispatch=n_syncs, syncs=syncs,
                rungs={str(b): dict(
                    dispatches=len(v), p50_ms=1e3 * pct(v, 50),
                    p99_ms=1e3 * pct(v, 99),
                    certified_bound_ms=1e3 * bounds[b])
                    for b, v in sorted(rungs.items())},
                dispatched_shapes=stats["dispatched_shapes"])
            rt._batcher.apply_fn = apply_fn
            k1_serving = k1

            # ---- hot swap mid-traffic to the fit on other labels; with
            # --swap-repeats K, K more swaps follow, each to a fresh load
            # of the other version (ROADMAP queue 3's chase)
            tol = SERVE_SCORE_RTOL * scale

            def swap_round(old_ref, new_ref, new_fitted):
                """Traffic from 8 threads, a swap to ``new_fitted`` in
                the middle: each answer's version, and for each answer
                from neither its row, errors, finiteness, time against
                the swap's window and the rows whose answer it equals
                under either version (a staging mix-up, not a corrupt
                product)."""
                stop = threading.Event()
                outcomes, swap_errors, neither = [], [], []
                swap_t0 = time.perf_counter()
                dispatches0 = count("serving.dispatches")

                def swap_client(i):
                    while not stop.is_set():
                        j = i % len(x_img)
                        try:
                            y = rt.submit(x_img[j])
                        except Exception as e:
                            swap_errors.append(repr(e))
                            return
                        err_a = float(np.abs(y - old_ref[j]).max())
                        err_b = float(np.abs(y - new_ref[j]).max())
                        outcomes.append((err_a <= tol, err_b <= tol))
                        if not any(outcomes[-1]):
                            neither.append(dict(
                                row=j, err_a=err_a, err_b=err_b,
                                finite=bool(np.isfinite(y).all()),
                                seconds=time.perf_counter() - swap_t0,
                                equals_rows_old=np.flatnonzero(np.abs(
                                    old_ref - y).max(axis=1) <= tol).tolist(),
                                equals_rows_new=np.flatnonzero(np.abs(
                                    new_ref - y).max(axis=1) <= tol).tolist()))
                        i += SERVE_CLIENTS

                threads = [threading.Thread(target=swap_client, args=(i,))
                           for i in range(SERVE_CLIENTS)]
                for t in threads:
                    t.start()
                time.sleep(SERVE_SWAP_SECONDS)
                swap_captures0 = len(captured_on)
                window = [time.perf_counter() - swap_t0]
                rt.swap(new_fitted)
                window.append(time.perf_counter() - swap_t0)
                swap_threads = set(captured_on[swap_captures0:])
                time.sleep(SERVE_SWAP_SECONDS)
                stop.set()
                for t in threads:
                    t.join()
                post = rt.submit(x_img[5])
                return dict(
                    answers=len(outcomes),
                    old=sum(a for a, _ in outcomes),
                    new=sum(b and not a for a, b in outcomes),
                    neither=len(neither), neither_first=neither[:5],
                    errors=swap_errors[:3],
                    dispatches=count("serving.dispatches") - dispatches0,
                    captures=len(captured_on) - swap_captures0,
                    capture_threads=sorted(swap_threads),
                    window_s=window,
                    post_new=bool(np.abs(post - new_ref[5]).max() <= tol))

            rounds = [swap_round(ref, ref_b, rpc_b)]
            for k in range(SWAP_REPEATS):
                back = k % 2 == 0  # b → a, then a → b, ...
                rounds.append(swap_round(
                    ref_b if back else ref, ref if back else ref_b,
                    FittedPipeline.load(os.path.join(
                        tmp, "rpc_a.pkl" if back else "rpc_b.pkl"),
                        device=dev)))
            first = rounds[0]
            for n, r in enumerate(rounds):
                check(not r["errors"], f"hot swap {n} lost requests: "
                      f"{r['errors']}")
                check(r["answers"] and not r["neither"],
                      f"hot swap {n}: an answer during the swap is from "
                      f"neither version: {r['neither']} of {r['answers']}, "
                      f"the swap from {r['window_s'][0]:.4f} s to "
                      f"{r['window_s'][1]:.4f} s, the first "
                      f"{r['neither_first']} (tolerance {tol:.3g}); every "
                      f"round: {[x['neither'] for x in rounds]}")
                check(r["new"] > 0, f"hot swap {n}: no answer came from "
                      "the new version")
                check(r["post_new"], f"after hot swap {n} an answer is not "
                      "the new version's")
                check(not any(t.endswith("-batcher")
                              for t in r["capture_threads"]),
                      f"a capture on the dispatcher's thread: "
                      f"{r['capture_threads']}")
            out["hot_swap"] = dict(
                answers=first["answers"], old=first["old"],
                new=first["new"], captures=first["captures"],
                capture_threads=first["capture_threads"],
                hot_swaps=count("serving.hot_swaps"),
                dispatches=first["dispatches"])
            if SWAP_REPEATS:
                out["hot_swap_repeats"] = [
                    {k: r[k] for k in ("answers", "old", "new", "neither",
                                       "neither_first", "dispatches",
                                       "captures", "window_s")}
                    for r in rounds[1:]]
            rt.stop()

            # ---- the kill switch: each request on its caller's thread
            with config_override(serving_coalesce=False):
                rt_k = ServingRuntime(rpc, NdarrayIngress(x_img.shape[1:]),
                                      envelope=envelope, name="kill",
                                      device=dev).start()
            rows = x_img[:SERVE_KILL_REQUESTS]
            direct = [rpc.apply(Dataset(rows[i:i + 1], device=dev))
                      .array.cpu().numpy()[0] for i in range(len(rows))]
            answers, _, errors = fire(rt_k, rows, SERVE_CLIENTS)
            rt_k.stop()
            check(not errors, f"kill-switch errors: {errors[:3]}")
            check(all(np.array_equal(answers[i], direct[i])
                      for i in range(len(rows))),
                  "a kill-switch answer is not the per-row apply bit for bit")
            check(rt_k.stats()["dispatched_shapes"] == [1],
                  f"kill switch dispatched {rt_k.stats()}")
            out["kill_switch"] = dict(requests=len(rows), bit_for_bit=True)

            # ---- shed: a burst into a queue of depth 4
            flight_dir = os.path.join(tmp, "flight")
            os.makedirs(flight_dir)
            os.environ["KEYSTONE_FLIGHT_DIR"] = flight_dir
            with config_override(serving_queue_depth=SERVE_SHED_DEPTH):
                rt_s = ServingRuntime(rpc, NdarrayIngress(x_img.shape[1:]),
                                      envelope=envelope, name="shed",
                                      device=dev).start()
            shed0 = count("serving.shed_total")
            rows = x_img[:SERVE_SHED_BURST]
            answers, _, errors = fire(rt_s, rows, SERVE_SHED_BURST)
            rt_s.stop()
            del os.environ["KEYSTONE_FLIGHT_DIR"]
            shed = count("serving.shed_total") - shed0
            dumps = [f for f in os.listdir(flight_dir) if "_shed" in f]
            wrong = [i for i, y in answers.items()
                     if np.abs(y - ref[i]).max() > SERVE_SCORE_RTOL * scale]
            check(shed > 0 and dumps, f"no shed ({shed}) or no flight dump")
            check(all("ShedError" in e for _, e in errors),
                  f"a burst request failed otherwise: {errors[:3]}")
            check(not wrong, f"answered requests wrong: {wrong[:5]}")
            out["shed"] = dict(burst=len(rows), queue_depth=SERVE_SHED_DEPTH,
                               shed=shed, answered=len(answers),
                               flight_dumps=len(dumps))

            # ---- LinearPixels: K4 in its replays. Its classes are served:
            # without the argmax, the optimizer's megafusion stops before
            # the fitted map (no member follows the fit)
            lp = fit_loaded(lambda d: build_linear_pixels(
                d, LinearPixelsConfig()), train, tmp, "lp", scores=False)
            rows = x_img[:SERVE_LP_REQUESTS]
            lp_ref = lp.apply(Dataset(rows, device=dev)).array.cpu().numpy()
            rt_lp = ServingRuntime(lp, NdarrayIngress(rows.shape[1:]),
                                   envelope=envelope, name="LinearPixels",
                                   device=dev).start()
            kernels.reset_launches()
            replays0 = count("megafusion.graph_replays")
            captures0 = count("megafusion.graph_captures")
            t0 = time.perf_counter()
            answers, seconds, errors = fire(rt_lp, rows, SERVE_CLIENTS)
            lp_seconds = time.perf_counter() - t0
            k4 = chain_kernels.elementwise_chain.launches
            replays = count("megafusion.graph_replays") - replays0
            check(not errors, f"LinearPixels errors: {errors[:3]}")
            got = np.stack([answers[i] for i in range(len(rows))])
            lp_wrong = int((got != lp_ref).sum())
            check(lp_wrong == 0,
                  f"LinearPixels: {lp_wrong} served classes differ from the "
                  "batch apply's")
            check(k4 > 0 and replays > 0 and k4 % replays == 0
                  and count("megafusion.graph_captures") == captures0,
                  f"LinearPixels: K4 {k4} in {replays} replays")
            out["linear_pixels"] = dict(
                requests=len(rows), seconds=lp_seconds,
                requests_per_sec=len(rows) / lp_seconds,
                p50_ms=1e3 * pct(list(seconds.values()), 50),
                p99_ms=1e3 * pct(list(seconds.values()), 99),
                classes_differing=lp_wrong, k4=k4, replays=replays,
                peak_bytes=rt_lp.certificate.per_device_peak_bytes)
            k4_serving = k4

            # ---- tenants priced against a stated budget (KP905)
            peak = rt.certificate.per_device_peak_bytes
            fits = TenantRegistry(hbm_budget_bytes=peak)
            fits.admit("RandomPatchCifar", rt)
            tight = TenantRegistry(hbm_budget_bytes=peak - 1)
            try:
                tight.admit("RandomPatchCifar", rt)
                refused = False
            except AdmissionRefused:
                refused = True
            check(refused and fits.tenants() == ["RandomPatchCifar"],
                  "the registry did not refuse the over-budget tenant")
            out["registry"] = dict(peak_bytes=peak, admitted=fits.tenants(),
                                   refused_at=peak - 1)
            rt_lp.stop()

        # ---- Newsgroups: host tokens at ingress, the device tail served
        labels, docs = synthetic_corpus(SERVE_NEWS_DOCS, NEWS_CLASSES)
        docs = HostDataset(docs.items, device=dev)
        PipelineEnv.reset()
        news = build_newsgroups_predictor(docs, labels, NEWS_CLASSES).fit()
        doc_list = list(docs)[:SERVE_NEWS_REQUESTS]
        direct = [int(news.apply(d)) for d in doc_list]
        host_ops, tail = split_fitted_at(news, "NaiveBayesModel")
        ingress = TextIngress(host_ops)
        rt_n = ServingRuntime(tail, ingress,
                              element_shape=ingress.accept(doc_list[0]).shape,
                              envelope=envelope, name="Newsgroups",
                              device=dev).start()
        answers, _, errors = fire(rt_n, doc_list, SERVE_CLIENTS)
        rt_n.stop()
        check(rt_n.certificate.certified, "the Newsgroups tail did not "
              "certify")
        check(not errors and all(int(answers[i]) == direct[i]
                                 for i in range(len(doc_list))),
              f"Newsgroups served classes differ: {errors[:3]}")
        out["newsgroups"] = dict(
            requests=len(doc_list), host_stages=[op.label for op in host_ops],
            features=int(ingress.accept(doc_list[0]).shape[0]))
    finally:
        graphs.CapturedLoop.__init__ = capture_init
    phase("serving", certificates=certs, **out,
          seconds=time.perf_counter() - t_phase, card=card)
    return dict(k1=k1_serving, k4=k4_serving)


def plan_report(applied):
    """The planners' decisions for the graph a run optimizes, made by
    calling them directly (their rules swallow a failure, as JAX's do):
    `plan_unified` as `UnifiedPlannerRule` calls it, and
    `plan_stage_precision` on each fused program, on the fused plan."""
    from keystone_tpu_torch.analysis.plan_ir import plan_unified
    from keystone_tpu_torch.analysis.precision import plan_stage_precision
    from keystone_tpu_torch.analysis.propagate import spec_pass
    from keystone_tpu_torch.workflow.env import execution_config
    from keystone_tpu_torch.workflow.optimizer import (
        DefaultOptimizer,
        _fused_program,
    )

    cfg = execution_config()
    fused, _ = DefaultOptimizer(
        unified_planner=False, sharding_planner=False,
        precision_planner=False).execute(applied.executor.graph)
    specs, _ = spec_pass(fused, {})
    uplan = plan_unified(
        fused, specs, hbm_budget_bytes=cfg.hbm_budget_bytes,
        chunk_default=cfg.chunk_size, include_boundary_policies=False,
        precision_floor_bytes=cfg.precision_min_savings_bytes)
    trails = {}
    for vid in sorted(fused.operators, key=lambda v: v.id):
        op = fused.get_operator(vid)
        if _fused_program(op):
            decided = plan_stage_precision(fused, vid, op, specs)
            trails[f"{op.label}@{vid.id}"] = None if decided is None \
                else dict(storage=list(decided[0]), bytes_saved=decided[1])
    return uplan, trails


def decisions_by_kind(records) -> dict:
    out = collections.Counter(f"{r['kind']}:{r['rule']}" for r in records)
    return dict(sorted(out.items()))


def planners_phase(dev, train, test, config, lp_config, card) -> dict:
    """Phase 27: RandomPatchCifar and LinearPixels at full width through
    `Pipeline.fit` with the planners on (the default), with the
    precision planner alone (the unified planner off: its trails are
    enforced as they are), and off; returns the K1 and K4 launches of
    the planner-on runs."""
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.ops import chain_kernels, kernels
    from keystone_tpu_torch.pipelines.cifar_variants import (
        build_linear_pixels,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        build_pipeline,
        learn_filters,
    )
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.env import (
        config_override,
        planned_chunk_size,
    )

    phase_t0 = time.perf_counter()
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    learned = learn_filters(train.data, config)
    arms = (("on", {}), ("precision_only", dict(unified_planner=False)),
            ("off", dict(unified_planner=False, precision_planner=False,
                         sharding_planner=False)))
    out, launches = {}, {}
    for name, build in (
            ("random_patch_cifar",
             lambda: build_pipeline(train, config, learned)),
            ("linear_pixels", lambda: build_linear_pixels(train, lp_config))):
        runs = {}
        # the planners called directly on the graph the fit optimizes,
        # before any fit fills the prefix table
        PipelineEnv.reset()
        uplan, trails = plan_report(build()(train.data))
        for arm, cfg in arms:
            with config_override(**cfg):
                PipelineEnv.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                mark = ledger.session_mark()
                kernels.reset_launches()
                t0 = time.perf_counter()
                pipe = build()
                fitted = pipe.fit()
                acc = evaluator(fitted.apply(test.data),
                                test.labels).accuracy
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = dict(k1=kernels.conv_rectify_pool.launches,
                              k4=chain_kernels.elementwise_chain.launches)
                records = ledger.session_since(mark)
                runs[arm] = dict(
                    test_accuracy=acc, seconds=seconds,
                    peak_mem_bytes=torch.cuda.max_memory_allocated(),
                    launches=counts, planned_chunk=planned_chunk_size(),
                    decisions=decisions_by_kind(records),
                    precision_tags=[r["chosen"]["storage"] for r in records
                                    if r["kind"] == "precision"])
                if arm == "on":
                    launches[name] = counts
            del pipe, fitted
        check(uplan is not None, f"{name}: plan_unified returned nothing")
        # JAX prices RandomPatchCifar's featurizer trail; LinearPixels'
        # GrayScaler declares no tolerance, so it has none in either
        check(name != "random_patch_cifar"
              or any(t is not None for t in trails.values()),
              f"{name}: plan_stage_precision priced no trail")
        runs["plan_unified"] = dict(
            sequential_seconds=uplan.sequential_seconds,
            joint_seconds=uplan.joint_seconds, improved=uplan.improved,
            changed_kinds=uplan.changed_kinds(), chunk=uplan.chunk_size)
        runs["trails"] = trails
        out[name] = runs
        for arm in ("on", "precision_only"):
            gap = abs(runs[arm]["test_accuracy"]
                      - runs["off"]["test_accuracy"])
            check(gap <= PLANNER_ACC_GAP, f"{name}: planners {arm} and off "
                  f"differ by {gap} in test accuracy")
            # the kernel axis keeps every chain kernel (decision (b))
            check(runs[arm]["launches"]["k4"]
                  == runs["off"]["launches"]["k4"],
                  f"{name}: K4 launched {runs[arm]['launches']['k4']} "
                  f"times ({arm}), {runs['off']['launches']['k4']} without "
                  "planners")
    rpc = out["random_patch_cifar"]
    check(ACC_BAND[0] <= rpc["on"]["test_accuracy"] <= ACC_BAND[1],
          f"RandomPatchCifar planner-on test accuracy "
          f"{rpc['on']['test_accuracy']} outside {ACC_BAND}")
    check(ACC_BAND[0] <= rpc["precision_only"]["test_accuracy"]
          <= ACC_BAND[1], f"RandomPatchCifar precision-only test accuracy "
          f"{rpc['precision_only']['test_accuracy']} outside {ACC_BAND}")
    # the trail that puts bf16 in front of K1 (decision (c)): K1 on the
    # bf16 PixelScaler output of test images against its plain version
    # on the same values, at K1's limit
    check(any(t[0] == "bfloat16"
              for t in rpc["precision_only"]["precision_tags"]),
          "RandomPatchCifar: the precision planner put no bf16 trail in "
          "front of K1")
    cv = Convolver(learned[0], 32, 32, 3, whitener=learned[1],
                   normalize_patches=True)
    x = (test.data.array[:HEADLINE_N] / 255.0).to(torch.bfloat16)
    g = kernels.hwio_to_cmajor(cv.kernel).contiguous()
    args = (cv.colsum.contiguous(), cv.bias.contiguous(), config.alpha, 0.0,
            config.pool_size, config.pool_stride, True)
    before = kernels.conv_rectify_pool.launches
    got = kernels.conv_rectify_pool(x, g, *args, cv.patch)
    torch.cuda.synchronize()
    kernels.conv_rectify_pool.launches = before  # a check, not the path
    want = kernels.conv_rectify_pool_reference(x.float(), cv.kernel, *args)
    err, rel = rel_err(got, want)
    k1_bf16 = dict(n=HEADLINE_N, max_abs_err=err, rel_err=rel,
                   tolerance_rel=K1_TOL)
    check(rel <= K1_TOL, f"K1 on bf16 images: relative error {rel} > "
          f"{K1_TOL}")
    del x, g, got, want
    phase("planners", **out, k1_bf16_input=k1_bf16, voc=VOC_PLAN,
          phase_seconds=time.perf_counter() - phase_t0, card=card)
    return launches


def out_of_core_phase(dev, config, card) -> dict:
    """Phase 28: RandomPatchCifar at full width trained from OOC_N
    CIFAR-shaped images drawn a shard at a time, under an HBM budget of
    OOC_BUDGET and without one; returns the budgeted run's K1 launches."""
    from keystone_tpu_torch.data.dataset import Dataset, SpilledDataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import (
        CifarShards,
        synthetic_cifar_out_of_core,
    )
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        build_pipeline,
        learn_filters,
    )
    from keystone_tpu_torch.telemetry import counter, histogram, ledger
    from keystone_tpu_torch.utils.batching import _window_plan
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.autocache import CacheMarker
    from keystone_tpu_torch.workflow.env import (
        config_override,
        resolved_chunk_size,
    )

    phase_t0 = time.perf_counter()
    images, labels = synthetic_cifar_out_of_core(
        OOC_N, OOC_SHARD, num_classes=config.num_classes, seed=config.seed,
        device=dev)
    train = LabeledData(labels=labels, data=images)
    tx, ty = CifarShards(config.num_classes, config.seed).shard(
        OOC_TEST, config.seed + OOC_TEST_SEED)
    test = LabeledData(labels=Dataset(ty, device=dev),
                       data=Dataset(tx, device=dev))
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    t0 = time.perf_counter()
    learned = learn_filters(images, config)
    filter_seconds = time.perf_counter() - t0
    spill_names = ("spill.bytes_out", "spill.bytes_in",
                   "spill.window_trips")
    stall = histogram("spill.reload_stall_s")
    runs, launches = {}, {}
    for arm, budget in (("budgeted", OOC_BUDGET), ("unbudgeted", None)):
        with config_override(hbm_budget_bytes=budget):
            PipelineEnv.reset()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mark = ledger.session_mark()
            before = {n: counter(n).value for n in spill_names}
            stall_before = stall.total
            kernels.reset_launches()
            t0 = time.perf_counter()
            applied = build_pipeline(train, config, learned)(test.data)
            graph = applied.executor.optimized_graph
            chunk = resolved_chunk_size()
            pred = applied.get()
            acc = evaluator(pred, test.labels).accuracy
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            k1 = kernels.conv_rectify_pool.launches
            records = ledger.session_since(mark)
            windows = _window_plan(OOC_N, chunk)
            want = (sum(math.ceil(p / config.microbatch)
                        for _, _, p in windows)
                    + math.ceil(OOC_TEST / config.microbatch))
            run = dict(
                seconds=seconds, test_accuracy=acc, k1_launches=k1,
                k1_launches_expected=want, windows=len(windows),
                chunk=chunk, budget_bytes=budget,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                decisions=decisions_by_kind(records),
                host_caches=[op.label for op in graph.operators.values()
                             if isinstance(op, CacheMarker)
                             and op.placement == "host"],
                spill={n: counter(n).value - before[n]
                       for n in spill_names},
                reload_stall_seconds=stall.total - stall_before)
            check(k1 == want, f"out_of_core {arm}: K1 launched {k1} times, "
                  f"not once a microbatch of its {len(windows)} windows "
                  f"and of the test images ({want})")
            if arm == "budgeted":
                spills = [r for r in records if r["kind"] == "spill"]
                check(bool(run["host_caches"] and spills),
                      "out_of_core: the budgeted plan holds no host cache "
                      "or no spill record")
                check(any(a["entry"].startswith("cache_")
                          and not a["feasible"]
                          for a in spills[0]["alternatives"]),
                      "out_of_core: the spill record's alternatives hold "
                      "no infeasible device cache")
                run["predicted_reload_seconds"] = \
                    spills[0]["predicted"].get("reload_seconds")
                run["spill_chosen"] = spills[0]["chosen"]
                launches["k1"] = k1
            run["predictions"] = pred.array.cpu()
            runs[arm] = run
            del applied, pred, graph
    a = runs["budgeted"].pop("predictions")
    b = runs["unbudgeted"].pop("predictions")
    agree = float((a == b).float().mean())
    # one spilled cache's round trip at the featurized size, against the
    # planner's reload_seconds for it (2 · bytes / host_bw + a dispatch a
    # window trip): the spill into pinned memory, then a whole re-entry
    PipelineEnv.reset()
    torch.cuda.empty_cache()
    rows = Dataset(torch.zeros((OOC_N, 2 * 2 * 2 * config.num_filters),
                               device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spilled = SpilledDataset.spill(rows)
    spill_s = time.perf_counter() - t0
    del rows
    t0 = time.perf_counter()
    back = spilled.rehydrate()
    torch.cuda.synchronize()
    round_trip = dict(bytes=spilled.nbytes, spill_seconds=spill_s,
                      rehydrate_seconds=time.perf_counter() - t0,
                      predicted_reload_seconds=runs["budgeted"][
                          "spill_chosen"]["spills"][0]["reload_seconds"])
    del spilled, back
    phase("out_of_core", train_images=OOC_N, shard_rows=OOC_SHARD,
          shards=math.ceil(OOC_N / OOC_SHARD), test_images=OOC_TEST,
          source_bytes=OOC_N * 32 * 32 * 3 * 4,
          filter_seconds=filter_seconds, agreement=agree, **runs,
          spill_round_trip=round_trip,
          phase_seconds=time.perf_counter() - phase_t0, card=card)
    check(ACC_BAND[0] <= runs["budgeted"]["test_accuracy"] <= ACC_BAND[1],
          f"out_of_core test accuracy {runs['budgeted']['test_accuracy']} "
          f"outside {ACC_BAND}")
    check(agree >= OOC_AGREE, f"out_of_core: the budgeted run agrees with "
          f"the unbudgeted one on {agree} of the test images")
    return launches


def measurement_phase(dev, train, test, config, lp_config, card) -> dict:
    """Phase 29: the measurement tier on the card (see the module
    docstring); returns the kernels' launches in its traced runs."""
    from keystone_tpu_torch import compile_bench, dispatch_bench
    from keystone_tpu_torch.analysis import ServingEnvelope, reconcile
    from keystone_tpu_torch.analysis.contracts import audit_registry
    from keystone_tpu_torch.analysis.serving import certify_example
    from keystone_tpu_torch.nodes.learning import cost_model
    from keystone_tpu_torch.ops import chain_kernels, kernels
    from keystone_tpu_torch.pipelines.cifar_variants import build_linear_pixels
    from keystone_tpu_torch.pipelines.random_patch_cifar import build_pipeline
    from keystone_tpu_torch.serving import NdarrayIngress, ServingRuntime
    from keystone_tpu_torch.telemetry import (
        ledger,
        load_trace,
        registry,
        to_chrome_trace,
        trace_run,
    )
    from keystone_tpu_torch.telemetry.watchdog import _padded_shape
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.env import config_override
    from keystone_tpu_torch.workflow.executor import drain_warmups

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    out = {}

    # ---- dispatch: every example under every plan
    t0 = time.perf_counter()
    names = tuple(dispatch_bench.EXAMPLES)
    rep = dispatch_bench.dispatch_count_report(names, device=dev)
    dispatch = {}
    for ex in names:
        e = rep["examples"][ex]
        dispatch[ex] = {p: dict(
            fit_programs=e["fit_run_programs"][p],
            apply_programs=e["apply_run_programs"][p],
            # [fit run, apply run] each
            k1=[e["device"][p][r]["conv_rectify_pool"]
                for r in ("fit", "apply")],
            k4=[e["device"][p][r]["elementwise_chain"]
                for r in ("fit", "apply")],
            graph_replays=[e["device"][p][r]["graph_replays"]
                           for r in ("fit", "apply")],
            syncs=[e["device"][p][r]["syncs"] for r in ("fit", "apply")])
            for p in dispatch_bench.PLANS}
    out["dispatch"] = dict(
        seconds=time.perf_counter() - t0, examples=dispatch,
        all_outputs_match=rep["all_outputs_match"],
        precision_in_band=rep["precision_in_band"],
        decisions_reconciled=rep["decisions_reconciled"],
        examples_at_one_program=rep["examples_at_one_program"])
    phase("measurement.dispatch", **out["dispatch"], card=card)
    check(rep["all_outputs_match"] and rep["precision_in_band"]
          and rep["decisions_reconciled"],
          "dispatch_count_report: outputs "
          f"{rep['all_outputs_match']}, precision "
          f"{rep['precision_in_band']}, decisions "
          f"{rep['decisions_reconciled']}")
    # every plan but serial_unfused fuses the featurizer (its peephole
    # takes K1, its chain K4); serial_unfused runs each stage alone
    fused_plans = dispatch_bench.PLANS[1:]
    check(all(sum(dispatch["RandomPatchCifar"][p]["k1"]) > 0
              and sum(dispatch["LinearPixels"][p]["k4"]) > 0
              for p in fused_plans),
          "a fused plan of the bench ran no K1 or no K4: "
          f"{dispatch['RandomPatchCifar']} {dispatch['LinearPixels']}")
    PipelineEnv.reset()

    # ---- compile: cold against warm, and the host-chunk tail
    t0 = time.perf_counter()
    crep = compile_bench.compile_count_report(device=dev)
    runs = {f"{ex}/{k}": dict(
        cold=dict(library_builds=r["cold_run"]["compiles"]["library_builds"],
                  graph_captures=r["cold_run"]["compiles"]["graph_captures"],
                  seconds=r["cold_run"]["seconds"]),
        warm=dict(library_builds=r["warm_run"]["compiles"]["library_builds"],
                  graph_captures=r["warm_run"]["compiles"]["graph_captures"],
                  seconds=r["warm_run"]["seconds"]),
        warm_beats_cold=r["warm_beats_cold"])
        for ex, e in crep["examples"].items() for k, r in e.items()}
    out["compile"] = dict(
        seconds=time.perf_counter() - t0, runs=runs,
        plan_breakdown=crep["plan_breakdown"], host_chunk=crep["host_chunk"],
        recapture=crep["recapture"],
        all_warm_runs_zero_compiles=crep["all_warm_runs_zero_compiles"],
        all_warm_captures_le_cold=crep["all_warm_captures_le_cold"],
        cold_runs_capture=crep["cold_runs_capture"],
        all_apply_compiles_bounded=crep["all_apply_compiles_bounded"],
        all_warm_beats_cold=crep["all_warm_beats_cold"])
    phase("measurement.compile", **out["compile"], card=card)
    hc = crep["host_chunk"]
    # every library was built by the kernels phase, so both runs build
    # none; the captures are the counts the runs differ by: each run
    # applies twice and captures at its second apply
    check(crep["all_warm_runs_zero_compiles"]
          and crep["all_warm_captures_le_cold"]
          and crep["cold_runs_capture"]
          and crep["all_apply_compiles_bounded"],
          f"compile_count_report: runs {runs}")
    check(crep["recapture"]["recapture_once_per_build"],
          f"a rebuilt pipeline's recaptures: {crep['recapture']}")
    check(hc["measured_by"] == "graph_captures"
          and hc["padded_graph_captures"] < hc["ragged_graph_captures"],
          f"host-chunk captures: padded {hc['padded_graph_captures']}, "
          f"ragged {hc['ragged_graph_captures']}")
    PipelineEnv.reset()

    # ---- reconcile at full width
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rpc_path = os.path.join(tmp, "rpc.json")
        lp_path = os.path.join(tmp, "lp.json")
        apply_path = os.path.join(tmp, "rpc_apply.json")
        PipelineEnv.reset()
        kernels.reset_launches()
        # node spans that wait for the card: the emitted calibration
        # reads their seconds
        with config_override(ledger_path=rpc_path + ".ledger.jsonl"), \
                trace_run(rpc_path, synchronize=True):
            build_pipeline(train, config)(test.data).get()
            sync()
        k1 = kernels.conv_rectify_pool.launches
        PipelineEnv.reset()
        kernels.reset_launches()
        with trace_run(lp_path):
            build_linear_pixels(train, lp_config)(test.data).get()
            sync()
        k4 = chain_kernels.elementwise_chain.launches
        # one apply run, alone in its trace, with a fresh registry
        PipelineEnv.reset()
        predictor = build_pipeline(train, config)
        predictor(test.data).get()
        sync()
        drain_warmups()
        ledger.clear_session()
        registry().reset()
        with trace_run(apply_path):
            predictor(test.data).get()
            sync()
        rpc_trace, lp_trace = load_trace(rpc_path), load_trace(lp_path)
        mem = reconcile.reconcile_trace(rpc_trace)
        joined = [r for r in mem["rows"] if r["rel_error"] is not None]
        worst = max(joined, key=lambda r: abs(r["rel_error"]))
        roof = reconcile.reconcile_roofline(rpc_trace)
        lp_roof = reconcile.reconcile_roofline(lp_trace)
        decisions = reconcile.reconcile_decisions(
            ledger.read_ledger(apply_path))
        drift = reconcile.cost_model_drift(rpc_trace)
        chain_spans = sum(1 for e in lp_trace["traceEvents"]
                          if e.get("name") == "chain_kernel")
        cal_path = os.path.join(tmp, "drift_calibration.json")
        t_cli = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch.telemetry",
             "--ledger", rpc_path, "--emit-calibration", cal_path],
            cwd=MEASURE_REPO, capture_output=True, text=True, timeout=300)
        cli_seconds = time.perf_counter() - t_cli
        check(cli.returncode == 0, f"--emit-calibration exited "
              f"{cli.returncode}: {cli.stderr[-2000:]}")
        with open(cal_path) as f:
            emitted = json.load(f)

        # the serving ladder certified on the card's weights, then on the
        # emitted ones; the measured rungs of a traced serving run
        envelope = ServingEnvelope(max_batch=SERVE_MAX_BATCH,
                                   slo_seconds=1.0)
        before, _ = certify_example("RandomPatchCifar", envelope,
                                    device=dev)
        prior = os.environ.get("KEYSTONE_COST_CALIBRATION")
        os.environ["KEYSTONE_COST_CALIBRATION"] = cal_path
        try:
            resolved = cost_model.resolve_weights()
            after, _ = certify_example("RandomPatchCifar", envelope,
                                       device=dev)
        finally:
            if prior is None:
                os.environ.pop("KEYSTONE_COST_CALIBRATION", None)
            else:
                os.environ["KEYSTONE_COST_CALIBRATION"] = prior
        check(resolved == (emitted["cpu_weight"], emitted["mem_weight"],
                           emitted["network_weight"]),
              f"KEYSTONE_COST_CALIBRATION resolved {resolved}, the file "
              f"holds {emitted}")
    PipelineEnv.reset()
    fitted = without_argmax(build_pipeline(train, config)).fit()
    x_img = test.data.array[:MEASURE_REQUESTS].cpu().numpy()
    rt = ServingRuntime(fitted, NdarrayIngress(x_img.shape[1:]),
                        envelope=envelope, name="RandomPatchCifar",
                        device=dev).start()
    rungs = {}
    apply_fn = rt._batcher.apply_fn

    def timed(stacked):
        t = time.perf_counter()
        y = apply_fn(stacked)
        rungs.setdefault(_padded_shape(len(stacked)), []).append(
            time.perf_counter() - t)
        return y

    rt._batcher.apply_fn = timed
    todo, lock, errors = list(range(len(x_img))), threading.Lock(), []

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop()
            try:
                rt.submit(x_img[i], timeout=120.0)
            except Exception as e:  # recorded, checked below
                errors.append(repr(e))

    with trace_run() as tracer:
        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        observed = [dict(batch=b, chunk_shape=b,
                         p50_ms=1e3 * float(np.percentile(v, 50)),
                         p99_ms=1e3 * float(np.percentile(v, 99)),
                         dispatches=len(v))
                    for b, v in sorted(rungs.items())]
        tracer.metadata["serving_observed"] = observed
        tracer.metadata["serving"] = before.as_record()
        served = to_chrome_trace(tracer)
    rt.stop()
    del fitted, rt
    check(not errors, f"traced serving errors: {errors[:3]}")
    join_before = reconcile.reconcile_serving(served)
    served["keystone"]["serving"] = after.as_record()
    join_after = reconcile.reconcile_serving(served)
    PipelineEnv.reset()

    def ms(x):
        return None if x is None else 1e3 * x

    def by_batch(join):
        return {r["batch"]: r for r in join["rows"]}

    out["reconcile"] = dict(
        seconds=time.perf_counter() - t0, k1=k1, k4=k4,
        memory=dict(rows_joined=len(joined),
                    worst=dict(label=worst["label"],
                               static_bytes=worst["static_bytes"],
                               observed_bytes=worst["observed_bytes"],
                               rel_error=worst["rel_error"]),
                    peak_rel_error=mem["peak_rel_error"]),
        roofline=dict(
            stages_joined=roof["stages_joined"],
            predicted_seconds=roof["predicted_seconds"],
            observed_seconds=roof["observed_seconds"],
            stages=[dict(label=r["label"], bound=r["bound"],
                         predicted_s=r["predicted_seconds"],
                         observed_s=r["observed_seconds"])
                    for r in roof["rows"] if r["residual"] is not None],
            linear_pixels_kernels=lp_roof["kernels"],
            chain_kernel_spans=chain_spans),
        decisions=dict(run_predicted=decisions["run_predicted"],
                       run_observed=decisions["run_observed"],
                       residuals=decisions["residuals"]),
        drift=dict(rows=drift["rows"], spans=drift["spans"],
                   roofline=drift["roofline"]),
        emitted=dict(cpu_weight=emitted["cpu_weight"],
                     mem_weight=emitted["mem_weight"],
                     platform=emitted["provenance"]["platform"],
                     node_spans_synchronized=emitted["provenance"][
                         "node_spans_synchronized"],
                     cli_seconds=cli_seconds),
        serving=dict(
            requests=len(x_img), clients=SERVE_CLIENTS,
            rungs=[dict(batch=r["batch"],
                        bound_before_ms=ms(b["predicted_bound_seconds"]),
                        bound_after_ms=ms(a["predicted_bound_seconds"]),
                        p50_ms=ms(b["observed_p50_seconds"]),
                        p99_ms=ms(b["observed_p99_seconds"]),
                        holds_before=b["holds"], holds_after=a["holds"],
                        dispatches=r["dispatches"])
                   for r in observed
                   for b in [by_batch(join_before)[r["batch"]]]
                   for a in [by_batch(join_after)[r["batch"]]]],
            bounds_1_64_before_ms=[1e3 * s["predicted_seconds"]
                                   for s in before.shapes
                                   if s["batch"] in (1, SERVE_MAX_BATCH)],
            bounds_1_64_after_ms=[1e3 * s["predicted_seconds"]
                                  for s in after.shapes
                                  if s["batch"] in (1, SERVE_MAX_BATCH)],
            certified_before=before.certified,
            certified_after=after.certified))
    phase("measurement.reconcile", **out["reconcile"], card=card)
    check(k1 == 30, f"the traced RandomPatchCifar run launched K1 {k1} "
          "times")
    check(chain_spans >= 1 and k4 >= 1,
          f"LinearPixels' trace holds {chain_spans} chain_kernel spans "
          f"({k4} K4 launches)")
    check(decisions["run_predicted"].get("programs_executed") is not None
          and decisions["run_predicted"]["programs_executed"]
          == decisions["run_observed"].get("programs_executed"),
          f"the one-apply trace: predicted {decisions['run_predicted']} "
          f"against observed {decisions['run_observed']}")
    if dev.type == "cuda":
        check(emitted["provenance"]["platform"]
              == torch.cuda.get_device_name(dev)
              and emitted["provenance"]["node_spans_synchronized"],
              f"the emitted calibration names {emitted['provenance']}")
    check(join_before["shapes_joined"] >= 1,
          f"no rung joined its certified bound: {join_before}")

    # ---- contracts: the registry and the full-width specs
    t0 = time.perf_counter()
    findings, stats = audit_registry()
    per_rule = dict(collections.Counter(d.rule for _, d in findings))
    PipelineEnv.reset()
    report = build_pipeline(train, config)(test.data).validate(
        level="full", raise_on_error=False)
    rules = dict(collections.Counter(
        f"{d.rule}:{d.severity.name}" for d in report.diagnostics))
    t_cli = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.analysis",
         "--explain-roofline", "RandomPatchCifar"],
        cwd=MEASURE_REPO, capture_output=True, text=True, timeout=300)
    out["contracts"] = dict(
        seconds=time.perf_counter() - t0, classes=stats["classes"],
        probed=stats["probed"], findings_per_rule=per_rule,
        validate_full=dict(errors=len(report.errors),
                           warnings=len(report.warnings), rules=rules),
        explain_roofline=dict(rc=cli.returncode,
                              seconds=time.perf_counter() - t_cli,
                              lines=cli.stdout.splitlines()[:4]))
    phase("measurement.contracts", **out["contracts"], card=card)
    PipelineEnv.reset()
    check(not findings, f"the registry audit found {per_rule}")
    check(not report.errors and not any(r.startswith("KP5")
                                        for r in rules),
          f"validate(level='full') on RandomPatchCifar: {rules}")
    check(cli.returncode == 0, f"--explain-roofline exited "
          f"{cli.returncode}: {cli.stderr[-2000:]}")
    out["seconds"] = time.perf_counter() - t_phase
    phase("measurement", seconds=out["seconds"], card=card)
    return dict(k1=k1, k4=k4)


def nlp_accuracy(pred, gold) -> float:
    n = c = 0
    for p, g in zip(pred, gold):
        for a, b in zip(p, g):
            n += 1
            c += a == b
    return c / n


def nlp_phase(dev, card) -> dict:
    """Phase 30: the POS and NER taggers on the card (see the module
    docstring); returns each task's figures."""
    from keystone_tpu_torch.nodes.nlp import (
        NER,
        CoreNLPFeatureExtractor,
        LinearChainCRFTagger,
        POSTagger,
        generate_ner_corpus,
        generate_pos_corpus,
    )
    from keystone_tpu_torch.nodes.nlp.perceptron_tagger import (
        StructuredPerceptronTagger,
    )

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    out = {}
    launches0 = launch_counts()
    for task, gen, entry, jax_acc, jax_nll in (
            ("pos", generate_pos_corpus, POSTagger, NLP_POS_JAX_ACC,
             NLP_POS_JAX_NLL),
            ("ner", generate_ner_corpus, NER, NLP_NER_JAX_ACC,
             NLP_NER_JAX_NLL)):
        corpus = gen(NLP_N_TRAIN + NLP_N_TEST, 0)
        train, test = corpus[:NLP_N_TRAIN], corpus[NLP_N_TRAIN:]
        tokens = [[w for w, _ in s] for s in test]
        gold = [[t for _, t in s] for s in test]
        n_tokens = sum(len(t) for t in tokens)
        # the entry point: the tagger fits once a process on the card
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases hold
        t0 = time.perf_counter()
        annotator = entry.trained_crf(device=dev)
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        tagger = annotator.model
        fit_peak = torch.cuda.max_memory_allocated() - held
        hash_seconds = tagger.hash_seconds
        pred = tagger.predict_batch(tokens)  # warm
        t0 = time.perf_counter()
        pred = tagger.predict_batch(tokens)
        decode_seconds = time.perf_counter() - t0
        acc = nlp_accuracy(pred, gold)
        # the same fit again under the sync counter (the card's fits are
        # not bit-stable: its steps may differ by one)
        again = {}
        syncs, n_syncs = count_syncs(lambda: again.setdefault(
            "t", LinearChainCRFTagger(max_iter=NLP_MAX_ITER, device=dev)
            .train(train)))
        # the card's theta on the CPU path: tags, and the objective with
        # its gradient in float64 on both (the same function), and in
        # float32, whose rounding at a fitted theta is printed beside it
        theta = tagger.theta
        on_cpu = LinearChainCRFTagger(n_buckets=tagger.n_buckets,
                                      device=cpu)
        card_obj = tagger.objective(train)
        cpu_obj = on_cpu.objective(train)
        on_cpu.set_theta(theta.cpu())
        value32, grad32 = card_obj(theta)
        cpu_value32, cpu_grad32 = cpu_obj(theta.cpu())
        value, grad = card_obj(theta.double())
        cpu_value, cpu_grad = cpu_obj(theta.cpu().double())
        value32, cpu_value32 = float(value32), float(cpu_value32)
        value, cpu_value = float(value), float(cpu_value)
        grad_err = float((grad.cpu() - cpu_grad).abs().max())
        grad_scale = float(cpu_grad.abs().max())
        float32 = dict(
            value=value32, cpu_value=cpu_value32,
            grad_max_abs_err=float((grad32.cpu() - cpu_grad32).abs().max()),
            cpu_value_err_vs_float64=abs(cpu_value32 - cpu_value),
            cpu_grad_err_vs_float64=float(
                (cpu_grad32.double() - cpu_grad).abs().max()))
        cpu_pred = on_cpu.predict_batch(tokens)
        row = dict(
            train_sentences=NLP_N_TRAIN, train_tokens=sum(map(len, train)),
            test_tokens=n_tokens, tags=len(tagger.tags),
            theta_floats=theta.numel(), fit_seconds=fit_seconds,
            hash_seconds=hash_seconds,
            device_fit_seconds=fit_seconds - hash_seconds,
            steps=len(tagger.loss_history),
            evaluations=sum(tagger.linesearch_steps),
            syncs=n_syncs, sync_sites=syncs,
            steps_again=len(again["t"].loss_history),
            evaluations_again=sum(again["t"].linesearch_steps),
            final_nll=value32, final_nll_again=float(
                card_obj(again["t"].theta)[0]),
            jax_cpu_nll=jax_nll, nll_over_jax=value32 / jax_nll - 1.0,
            float64=dict(value=value, cpu_value=cpu_value,
                         grad_max_abs_err=grad_err,
                         grad_max_abs=grad_scale),
            float32=float32,
            test_accuracy=acc, jax_cpu_accuracy=jax_acc,
            decode_tokens_per_sec=n_tokens / decode_seconds,
            decode_seconds=decode_seconds,
            cpu_decode_equal=cpu_pred == pred, peak_bytes=fit_peak)
        if task == "pos":
            # the host structured perceptron on 600 sentences, 3 epochs
            t0 = time.perf_counter()
            perc = StructuredPerceptronTagger().train(
                train[:NLP_PERCEPTRON_SENTENCES], n_iter=NLP_PERCEPTRON_ITERS)
            perc_train = time.perf_counter() - t0
            t0 = time.perf_counter()
            perc_pred = [perc(t) for t in tokens]
            perc_seconds = time.perf_counter() - t0
            row.update(perceptron_accuracy=nlp_accuracy(perc_pred, gold),
                       perceptron_train_seconds=perc_train,
                       perceptron_tokens_per_sec=n_tokens / perc_seconds)
        else:
            bio = [(p, t) for pr in pred for p, t in zip(["O"] + pr, pr)
                   if t.startswith("I-") and p not in (t, "B-" + t[2:])]
            row["bio_violations"] = len(bio)
        out[task] = row
        check(acc > NLP_ACC_FLOOR, f"{task}: CRF accuracy {acc}")
        check(abs(acc - jax_acc) <= NLP_ACC_GAP, f"{task}: CRF accuracy "
              f"{acc}, JAX's CPU {jax_acc}")
        check(value32 <= jax_nll * (1.0 + NLP_NLL_RTOL),
              f"{task}: final NLL {value32}, JAX's CPU {jax_nll}")
        check(pred == cpu_pred, f"{task}: the CPU path decodes the card's "
              "weights otherwise")
        check(abs(value - cpu_value) <= NLP_VALUE_RTOL * abs(cpu_value),
              f"{task}: NLL {value} on the card, {cpu_value} on the CPU")
        check(grad_err <= NLP_GRAD_RTOL * grad_scale, f"{task}: gradient "
              f"{grad_err} from the CPU's (max {grad_scale})")
        if task == "pos":
            check(acc >= row["perceptron_accuracy"], f"pos: CRF accuracy "
                  f"{acc} under the perceptron's "
                  f"{row['perceptron_accuracy']}")
        else:
            check(not bio, f"ner: I- tags after neither I- nor B-: {bio[:5]}")
        del card_obj, cpu_obj, again
    # the annotators: entities replaced by the card's NER, n-grams equal
    # to the CPU path's on the same weights
    ner_test = generate_ner_corpus(NLP_N_TRAIN + NLP_N_TEST, 0)[NLP_N_TRAIN:]
    texts = [" ".join(w for w, _ in s) for s in ner_test[:NLP_ANNOTATED]]
    card_ner = NER.trained_crf(device=dev)
    tagger = card_ner.model
    on_cpu = LinearChainCRFTagger(n_buckets=tagger.n_buckets, device=cpu)
    on_cpu.tags = list(tagger.tags)
    on_cpu.set_theta(tagger.theta.cpu())
    grams = [CoreNLPFeatureExtractor(ner=card_ner).apply(t) for t in texts]
    cpu_grams = [CoreNLPFeatureExtractor(ner=NER(model=on_cpu)).apply(t)
                 for t in texts]
    entities = sum(g[0].isupper() and "-" in g[0] for gs in grams for g in gs
                   if len(g) == 1)
    out["annotators"] = dict(texts=len(texts), ngrams=sum(map(len, grams)),
                             entity_unigrams=entities,
                             equal_to_cpu=grams == cpu_grams)
    check(grams == cpu_grams, "CoreNLPFeatureExtractor's n-grams differ "
          "from the CPU path's")
    check(entities > 0, "no entity tag among the extracted unigrams")
    launches = {k: v - launches0.get(k, 0)
                for k, v in launch_counts().items()}
    out["kernel_launches"] = launches
    check(not any(launches.values()), f"a kernel launched in nlp: "
          f"{launches}")
    out["seconds"] = time.perf_counter() - t_phase
    phase("nlp", **out, card=card)
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _collective_spans(tracer, seconds: float, by_axis: bool = False) -> dict:
    """``{kind: {"calls", "bytes", "seconds", "share_of_train_seconds"}}``
    of the ``collective`` spans of a synchronizing tracer's run of
    ``seconds``; with ``by_axis``, keyed ``axis.kind``."""
    out = {}
    for rec in tracer.spans:
        if rec.cat == "collective":
            key = (f"{rec.args.get('axis')}.{rec.name}" if by_axis
                   else rec.name)
            row = out.setdefault(key, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
            row["calls"] += 1
            row["bytes"] += rec.args["bytes"]
            row["seconds"] += rec.dur
    for row in out.values():
        row["share_of_train_seconds"] = row["seconds"] / seconds
    return out


def parallel_phase(dev, train, test, config, card) -> dict:
    """31. parallel: RandomPatchCifar through `global_data_mesh()` of an
    NCCL group of world size 1, staged and fused, held to a one-process
    run of the same arrays made in this phase."""
    import socket

    import torch.distributed as dist

    from keystone_tpu_torch import parallel, telemetry
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        build_pipeline,
        learn_filters,
        run_fused,
    )
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    phase_t0 = time.perf_counter()
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    # the one-process run on the same arrays, before any group exists
    PipelineEnv.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = build_pipeline(train, config)
    evaluator(one(train.data), train.labels)
    torch.cuda.synchronize()
    one_seconds = time.perf_counter() - t0
    one_preds = one(test.data).get()
    one_acc = evaluator(one_preds, test.labels).accuracy
    one_fused_seconds, one_fused = timed_s(
        lambda: run_fused(train, test, config))
    del one

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    world = parallel.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda",
                                    timeout=PARALLEL_TIMEOUT_S)
    init_seconds = time.perf_counter() - t0
    out = dict(world=world, backend=dist.get_backend(),
               init_seconds=init_seconds)
    try:
        mesh = parallel.global_data_mesh()
        check(out["backend"] == "nccl" and parallel.n_data_shards(mesh) == 1,
              f"parallel: backend {out['backend']}, "
              f"{parallel.n_data_shards(mesh)} data shards")

        def place(split):
            return LabeledData(
                labels=Dataset(split.labels.array, split.labels.count,
                               mesh=mesh),
                data=Dataset(split.data.array, split.data.count, mesh=mesh))

        mtrain, mtest = place(train), place(test)
        check(mtrain.data.padded_count == mtrain.data.count
              and not mtrain.data.has_padding,
              "parallel: one rank pads rows")

        # staged: the pipeline through the executor on the mesh
        PipelineEnv.reset()
        kernels.reset_launches()
        with telemetry.metrics_delta() as delta, \
                telemetry.trace_run(synchronize=True) as tracer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor = build_pipeline(mtrain, config)
            train_metrics = evaluator(predictor(mtrain.data), mtrain.labels)
            torch.cuda.synchronize()
            train_seconds = time.perf_counter() - t0
            preds = predictor(mtest.data).get()
            test_metrics = evaluator(preds, mtest.labels)
        k1 = kernels.conv_rectify_pool.launches
        colls = _collective_spans(tracer, train_seconds)
        differ = int((preds.array != one_preds.array).sum())
        out["staged"] = dict(
            train_seconds=train_seconds,
            one_process_train_seconds=one_seconds,
            train_error=train_metrics.error,
            test_accuracy=test_metrics.accuracy,
            one_process_test_accuracy=one_acc, rows_differing=differ,
            k1_launches=k1, collectives=colls,
            counters={k: v for k, v in delta.counters().items()
                      if k.startswith("collectives.")})
        check(differ == 0, f"parallel staged: {differ} of {test.data.count} "
              "test predictions differ from the one-process run's")
        check(test_metrics.accuracy == one_acc,
              f"parallel staged: test accuracy {test_metrics.accuracy} != "
              f"the one-process run's {one_acc}")
        check(k1 == 30, f"parallel staged: K1 launched {k1} times, not 30")
        check(colls.get("all_reduce", {}).get("calls", 0) > 0
              and colls.get("broadcast", {}).get("calls", 0) > 0,
              f"parallel staged: collectives {sorted(colls)}")

        # K1 on the mesh path's rows against its plain version
        filters, whitener = learn_filters(mtrain.data, config)
        cv = Convolver(filters, 32, 32, 3, whitener=whitener,
                       normalize_patches=True)
        x = mtrain.data.array[:HEADLINE_N] / 255.0
        args = (cv.colsum.contiguous(), cv.bias.contiguous(), config.alpha,
                0.0, config.pool_size, config.pool_stride, True)
        before = kernels.conv_rectify_pool.launches
        got = kernels.conv_rectify_pool(
            x, kernels.hwio_to_cmajor(cv.kernel).contiguous(), *args,
            cv.patch)
        torch.cuda.synchronize()
        kernels.conv_rectify_pool.launches = before  # a check, not the path
        want = kernels.conv_rectify_pool_reference(x, cv.kernel, *args)
        err, rel = rel_err(got, want)
        out["k1_check"] = dict(n=HEADLINE_N, max_abs_err=err, rel_err=rel,
                               tolerance_rel=K1_TOL)
        check(rel <= K1_TOL, f"parallel: K1 on the mesh's rows, relative "
              f"error {rel} > {K1_TOL}")
        del x, got, want

        # fused: `run_fused` on the mesh
        PipelineEnv.reset()
        kernels.reset_launches()
        with telemetry.trace_run(synchronize=True) as ftracer:
            fused_seconds, fused = timed_s(
                lambda: run_fused(mtrain, mtest, config))
        k1_fused = kernels.conv_rectify_pool.launches
        fcolls = _collective_spans(ftracer, fused_seconds)
        w_equal = (torch.equal(fused["W"], one_fused["W"])
                   and torch.equal(fused["b"], one_fused["b"]))
        out["fused"] = dict(
            train_seconds=fused_seconds,
            one_process_train_seconds=one_fused_seconds,
            test_accuracy=fused["test_accuracy"],
            one_process_test_accuracy=one_fused["test_accuracy"],
            W_b_bit_equal=w_equal, k1_launches=k1_fused,
            collectives=fcolls, stage_ms=fused["stage_ms"],
            one_process_stage_ms=one_fused["stage_ms"])
        check(fused["test_accuracy"] == one_fused["test_accuracy"],
              f"parallel fused: test accuracy {fused['test_accuracy']} != "
              f"the one-process run's {one_fused['test_accuracy']}")
        check(w_equal, "parallel fused: W, b differ from the one-process "
              "run's")
        check(k1_fused == 30, f"parallel fused: K1 launched {k1_fused} "
              "times, not 30")

        # a distributed checkpoint of the fitted pipeline
        PipelineEnv.reset()
        fitted = build_pipeline(mtrain, config).fit()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "random_patch_cifar")
            save_seconds, _ = timed_s(lambda: fitted.save(path,
                                                          format="dcp"))
            ckpt_bytes = _dir_bytes(path)
            load_seconds, loaded = timed_s(
                lambda: FittedPipeline.load(path, device="cuda"))
        before_preds = fitted.apply(mtest.data).array
        after_preds = loaded.apply(mtest.data).array
        ckpt_equal = torch.equal(before_preds, after_preds)
        out["checkpoint"] = dict(save_seconds=save_seconds,
                                 load_seconds=load_seconds,
                                 bytes=ckpt_bytes,
                                 predictions_equal=ckpt_equal)
        check(ckpt_equal, "parallel: the loaded checkpoint predicts "
              "otherwise")
        p0 = telemetry.counter("dispatch.programs_executed.p0").value
        out["p0_programs"] = p0
        check(p0 > 0, "parallel: no p0 dispatch counter")
        del fitted, loaded, predictor
    finally:
        parallel.reset_default_mesh()
        dist.destroy_process_group()
        PipelineEnv.reset()
    out["phase_seconds"] = time.perf_counter() - phase_t0
    phase("parallel", **out, card=card)
    return dict(k1=out["staged"]["k1_launches"] + out["fused"]["k1_launches"],
                k1_check=out["k1_check"],
                one_preds=one_preds.array.cpu().numpy(),
                one_accuracy=one_acc,
                one_fused_W=one_fused["W"].cpu().numpy())


def _rpc_fit_graphs(config, device):
    """RandomPatchCifar's graphs at the slice's counts (50,000 train,
    10,000 test) over placeholder data, the featurizer `make_featurizer`'s
    fused program as `build_pipeline` has it: the fit with the train
    predict, and the test apply. Random filters and an identity whitener
    of the config's shapes stand in for the learned ones (the passes
    read shapes)."""
    from keystone_tpu_torch.analysis import SpecDataset
    from keystone_tpu_torch.nodes.learning.block_ls import (
        BlockLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener
    from keystone_tpu_torch.nodes.stats.scalers import StandardScaler
    from keystone_tpu_torch.nodes.util.basic import (
        Cacher,
        ClassLabelIndicatorsFromInt,
        MaxClassifier,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        make_featurizer,
    )

    rng = np.random.default_rng(config.seed)
    d = config.patch_size * config.patch_size * 3
    filters = torch.from_numpy(rng.normal(
        size=(config.num_filters, d)).astype(np.float32)).to(device)
    whitener = ZCAWhitener(torch.eye(d), torch.zeros(d), device=device)
    feats = (make_featurizer(filters, whitener, 32, 32, 3,
                             config).to_pipeline() >> Cacher("features"))
    train = SpecDataset((32, 32, 3), np.float32, count=N_TRAIN,
                        name="cifar-train")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(
        SpecDataset((), np.int32, count=N_TRAIN, name="cifar-labels"))
    predictor = (feats.and_then(StandardScaler(), train)
                 .and_then(BlockLeastSquaresEstimator(
                     config.block_size, config.bcd_iters, config.lam),
                     train, labels)
                 >> MaxClassifier())
    test = SpecDataset((32, 32, 3), np.float32, count=N_TEST,
                       name="cifar-test")
    return {"RandomPatchCifar.fit": predictor.apply(train).graph,
            "RandomPatchCifar.test": predictor.apply(test).graph}


_FAMILY_CODES = {"data": "d", "data_model": "dm", "model": "m",
                 "replicated": "r"}


def _run_lengths(families) -> str:
    """``"d2 dm3 d1"``: the families in order, run-length coded."""
    runs = []
    for f in families:
        code = _FAMILY_CODES[f]
        if runs and runs[-1][0] == code:
            runs[-1][1] += 1
        else:
            runs.append([code, 1])
    return " ".join(f"{c}{n}" for c, n in runs)


def model_axis_static(device, layouts=("2x4", "8x1", "1x2")) -> dict:
    """The static tier on the slice's RandomPatchCifar graphs and
    `dispatch_bench`'s four examples, per layout: the KP6xx findings,
    the per-device peak, and the sharding planner's default and planned
    boundary bytes and chosen families. Spec arithmetic only: the same
    numbers on the CPU and on the card."""
    from keystone_tpu_torch import dispatch_bench
    from keystone_tpu_torch.analysis.memory import memory_pass
    from keystone_tpu_torch.analysis.planner import plan_sharding
    from keystone_tpu_torch.analysis.propagate import spec_pass
    from keystone_tpu_torch.analysis.sharding import (
        per_device_pass,
        sharding_pass,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
    )

    graphs = _rpc_fit_graphs(RandomPatchCifarConfig(num_filters=256),
                             device)
    for name, build in dispatch_bench.EXAMPLES.items():
        predictor, train, _ = build(device)
        graphs[name] = predictor(train).graph
    out = {}
    for name, graph in graphs.items():
        specs, _ = spec_pass(graph, {})
        memory, _ = memory_pass(graph, specs)
        for shape in layouts:
            d, m = (int(v) for v in shape.split("x"))
            layout = {"data": d, "model": m}
            shardings, diags, _ = sharding_pass(graph, specs, mesh=layout)
            _, pd_diags = per_device_pass(graph, specs, shardings, memory,
                                          mesh=layout)
            plan = plan_sharding(graph, specs, mesh=layout)
            fams = None if plan is None else _run_lengths(
                f for _, f in sorted(plan.families.items(),
                                     key=lambda kv: (type(kv[0]).__name__,
                                                     getattr(kv[0], "id",
                                                             -1))))
            out[f"{name}@{shape}"] = dict(
                kp6xx=sorted(dg.rule for dg in diags + pd_diags),
                per_device_peak_bytes=int(memory.per_device_peak_bytes),
                plan=None if plan is None else [
                    int(plan.default_cost_bytes),
                    int(plan.planned_cost_bytes), plan.improved, fams])
    return out


def model_axis_rank(rank: int, port: int, out_dir: str) -> int:
    """One rank of phase 32: a gloo group of two ranks over the card's
    tensors, the (1, 2) mesh, RandomPatchCifar at the slice's width and
    counts staged and fused. Writes ``rank<r>.json`` and ``rank<r>.npz``
    into ``out_dir``."""
    from keystone_tpu_torch import parallel, telemetry
    from keystone_tpu_torch.analysis.memory import memory_pass
    from keystone_tpu_torch.analysis.propagate import spec_pass
    from keystone_tpu_torch.analysis.sharding import (
        per_device_pass,
        sharding_pass,
    )
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        build_pipeline,
        learn_filters,
        run_fused,
    )
    from keystone_tpu_torch.workflow import PipelineEnv

    t0 = time.perf_counter()
    parallel.init_multihost(f"127.0.0.1:{port}", 2, rank, device="cuda",
                            timeout=MODEL_AXIS_TIMEOUT_S, backend="gloo")
    res = dict(rank=rank, init_seconds=time.perf_counter() - t0)
    arr = {}
    try:
        mesh = parallel.global_data_mesh(model_shards=2)
        res["shards"] = [parallel.n_data_shards(mesh),
                         parallel.n_model_shards(mesh)]
        config = RandomPatchCifarConfig(num_filters=256)
        evaluator = MulticlassClassifierEvaluator(config.num_classes)
        # a warm run at a tenth of the counts: a fresh process's first
        # launches, meta traces and gloo buffers, outside the clocks
        t0 = time.perf_counter()
        wtrain, wtest = synthetic_cifar(N_TRAIN // 10, N_TEST // 10,
                                        noise=1.2, confusion=0.6,
                                        device="cuda", mesh=mesh)
        PipelineEnv.reset()
        warm = build_pipeline(wtrain, config)
        evaluator(warm(wtrain.data), wtrain.labels)
        evaluator(warm(wtest.data), wtest.labels)
        run_fused(wtrain, wtest, config)
        torch.cuda.synchronize()
        res["warm_seconds"] = time.perf_counter() - t0
        del warm, wtrain, wtest
        train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2,
                                      confusion=0.6, device="cuda",
                                      mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # staged: the pipeline through the executor on the mesh
        PipelineEnv.reset()
        kernels.reset_launches()
        with telemetry.metrics_delta() as delta, \
                telemetry.trace_run(synchronize=True) as tracer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor = build_pipeline(train, config)
            applied = predictor(train.data)
            train_metrics = evaluator(applied, train.labels)
            torch.cuda.synchronize()
            train_seconds = time.perf_counter() - t0
            preds = predictor(test.data).get()
            test_metrics = evaluator(preds, test.labels)
        model = predictor.fitted(1)
        res["staged"] = dict(
            train_seconds=train_seconds,
            train_error=train_metrics.error,
            test_accuracy=test_metrics.accuracy,
            k1_launches=kernels.conv_rectify_pool.launches,
            collectives=_collective_spans(tracer, train_seconds, True),
            counters={k: v for k, v in delta.counters().items()
                      if k.startswith("collectives.")})
        arr["staged_preds"] = preds.numpy()
        arr["staged_W"] = model.W.cpu().numpy()
        arr["staged_b"] = model.b.cpu().numpy()
        # the per-device model of the fit on this mesh, beside the peak
        specs, _ = spec_pass(applied.graph, {})
        memory, _ = memory_pass(applied.graph, specs)
        shardings, _, _ = sharding_pass(applied.graph, specs, mesh=mesh)
        per_device_pass(applied.graph, specs, shardings, memory, mesh=mesh)
        res["staged"]["per_device_peak_bytes_predicted"] = int(
            memory.per_device_peak_bytes)
        res["staged"]["peak_bytes"] = int(torch.cuda.max_memory_allocated())
        del predictor, applied, preds

        # K1 on this rank's rows against its plain version
        filters, whitener = learn_filters(train.data, config)
        cv = Convolver(filters, 32, 32, 3, whitener=whitener,
                       normalize_patches=True)
        x = train.data.array[:HEADLINE_N] / 255.0
        args = (cv.colsum.contiguous(), cv.bias.contiguous(), config.alpha,
                0.0, config.pool_size, config.pool_stride, True)
        before = kernels.conv_rectify_pool.launches
        got = kernels.conv_rectify_pool(
            x, kernels.hwio_to_cmajor(cv.kernel).contiguous(), *args,
            cv.patch)
        torch.cuda.synchronize()
        kernels.conv_rectify_pool.launches = before  # a check, not the path
        want = kernels.conv_rectify_pool_reference(x, cv.kernel, *args)
        err, rel = rel_err(got, want)
        res["k1_check"] = dict(n=HEADLINE_N, max_abs_err=err, rel_err=rel,
                               tolerance_rel=K1_TOL)
        del x, got, want

        # fused: `run_fused`, BCD on this rank's column tile
        PipelineEnv.reset()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with telemetry.metrics_delta() as fdelta, \
                telemetry.trace_run(synchronize=True) as ftracer:
            fused_seconds, fused = timed_s(
                lambda: run_fused(train, test, config))
        res["fused"] = dict(
            train_seconds=fused_seconds,
            test_accuracy=fused["test_accuracy"],
            k1_launches=kernels.conv_rectify_pool.launches,
            stage_ms=fused["stage_ms"],
            collectives=_collective_spans(ftracer, fused_seconds, True),
            counters={k: v for k, v in fdelta.counters().items()
                      if k.startswith("collectives.")},
            peak_bytes=int(torch.cuda.max_memory_allocated()))
        arr["fused_W"] = fused["W"].cpu().numpy()
        arr["fused_b"] = fused["b"].cpu().numpy()
        parallel.barrier()
    finally:
        parallel.reset_default_mesh()
        import torch.distributed as dist

        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arr)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def model_axis_phase(dev, card, par) -> dict:
    """32. model_axis: the static tier and the sharding planner on the
    slice's graphs and `dispatch_bench`'s examples (layouts 2x4 and 8x1,
    checked against the CPU's pinned values), the analysis CLI's
    ``--explain-sharding --plan --mesh-shape 2x4 --json`` in this
    process, then two ranks on the card, a gloo group over its tensors
    on the (1, 2) mesh: RandomPatchCifar staged and fused with BCD on the
    model axis, held to phase 31's one-process run."""
    import contextlib
    import io
    import socket

    from keystone_tpu_torch.analysis.__main__ import main as analysis_main

    phase_t0 = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    static = model_axis_static("cuda")
    out["static_seconds"] = time.perf_counter() - t0
    out["static"] = static
    for key, row in static.items():
        name, shape = key.split("@")
        if not name.startswith("RandomPatchCifar."):
            check(not row["kp6xx"], f"model_axis: {key} has KP6xx findings "
                  f"{row['kp6xx']}")
    for key, want in MODEL_AXIS_PINNED.items():
        got = static[key]["plan"]
        check(got == want, f"model_axis: {key}'s plan {got} != the CPU's "
              f"{want}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--explain-sharding", "--plan", "--mesh-shape",
                            "2x4", "--json"])
    cli = json.loads(buf.getvalue())
    out["cli"] = dict(
        seconds=time.perf_counter() - t0, rc=rc, devices=cli["devices"],
        findings=sum(len(e.get("findings", [])) for e in cli["examples"]),
        improved=sorted(e["example"] for e in cli["examples"]
                        if (e.get("planner") or {}).get("improved")))
    check(rc == 0 and out["cli"]["findings"] == 0 and cli["devices"] == 8,
          f"model_axis: the analysis CLI on 2x4: {out['cli']}")

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--model-axis-rank",
             str(r), "--model-axis-port", str(port), "--model-axis-out",
             tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MODEL_AXIS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["ranks_seconds"] = time.perf_counter() - t0
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"model_axis: rank {r} exited "
                  f"{p.returncode}:\n{logs[r][-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            ranks.append((res, dict(np.load(os.path.join(
                tmp, f"rank{r}.npz")))))
    for key in ("staged_preds", "staged_W", "staged_b", "fused_W",
                "fused_b"):
        check(np.array_equal(ranks[0][1][key], ranks[1][1][key]),
              f"model_axis: {key} differs between the ranks")
    arr = ranks[0][1]
    differ = int((arr["staged_preds"] != par["one_preds"]).sum())
    w_err = float(np.abs(arr["fused_W"] - par["one_fused_W"]).max())
    out["ranks"] = [res for res, _ in ranks]
    out["collective_seconds_are"] = (
        "gloo over the card's tensors, through host memory: not an "
        "NVLink or multi-card figure")
    out["staged_rows_differing"] = differ
    out["fused_W_max_abs_err"] = w_err
    out["one_process_test_accuracy"] = par["one_accuracy"]
    for res, _ in ranks:
        for run in ("staged", "fused"):
            acc = res[run]["test_accuracy"]
            check(abs(acc - MODEL_AXIS_ACC) <= MODEL_AXIS_ACC_TOL,
                  f"model_axis {run}: rank {res['rank']} accuracy {acc} "
                  f"not within {MODEL_AXIS_ACC_TOL} of {MODEL_AXIS_ACC}")
            check(res[run]["k1_launches"] == 30,
                  f"model_axis {run}: rank {res['rank']} launched K1 "
                  f"{res[run]['k1_launches']} times, not 30")
            model_colls = [k for k in res[run]["counters"]
                           if k.startswith("collectives.model.")]
            check(model_colls, f"model_axis {run}: rank {res['rank']} ran "
                  "no collective over the model axis")
        check(res["k1_check"]["rel_err"] <= K1_TOL,
              f"model_axis: K1 on rank {res['rank']}'s rows, relative "
              f"error {res['k1_check']['rel_err']} > {K1_TOL}")
    check(differ <= MODEL_AXIS_PRED_DIFF, f"model_axis staged: {differ} "
          f"test predictions differ from phase 31's one-process run "
          f"(at most {MODEL_AXIS_PRED_DIFF})")
    check(w_err <= MODEL_AXIS_W_ATOL, f"model_axis fused: W {w_err} from "
          f"one process's (atol {MODEL_AXIS_W_ATOL})")
    out["phase_seconds"] = time.perf_counter() - phase_t0
    phase("model_axis", **out, card=card)
    return dict(k1=sum(res[run]["k1_launches"] for res, _ in ranks
                       for run in ("staged", "fused")),
                k1_check=[res["k1_check"] for res, _ in ranks])


def _rank_launches() -> dict:
    """This process's launches of K1, K4 and K5 (products, prepasses)
    since the last `kernels.reset_launches`."""
    from keystone_tpu_torch.ops import chain_kernels, kernels

    return dict(conv_rectify_pool=kernels.conv_rectify_pool.launches,
                elementwise_chain=chain_kernels.elementwise_chain.launches,
                rbf_block=kernels.rbf_block.launches,
                rbf_split=kernels.rbf_split.launches)


def _data_axis_run(name, fn, res):
    """``fn()`` on this rank with the launch counts set to 0 just before
    and read just after, under a synchronizing trace: its seconds,
    launches, collectives (calls, bytes, span seconds), the planners'
    storage trails and counters, and peak memory into ``res[name]``;
    returns ``fn()``'s value."""
    from keystone_tpu_torch import telemetry
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mark = ledger.session_mark()
    with telemetry.metrics_delta() as delta, \
            telemetry.trace_run(synchronize=True) as tracer:
        seconds, out = timed_s(fn)
    res[name] = dict(
        seconds=seconds, launches=_rank_launches(),
        collectives=_collective_spans(tracer, seconds),
        counters={k: v for k, v in delta.counters().items()
                  if k.startswith(("collectives.", "planner."))},
        precision=precision_trails(mark),
        peak_bytes=int(torch.cuda.max_memory_allocated()))
    return out


def _krr_rows(model, key: str = "train_X") -> np.ndarray:
    """A fitted `KernelBlockLinearMapper`'s ``train_X`` or ``alpha``,
    every training row (gathered over the data axis it was fitted
    on)."""
    from keystone_tpu_torch.data.dataset import Dataset

    rows = getattr(model, key)
    if model.mesh is None:
        return rows[:model.count].cpu().numpy()
    return Dataset(rows, count=model.count, mesh=model.mesh,
                   placed=True).numpy()


def _krr_alpha(model) -> np.ndarray:
    return _krr_rows(model, "alpha")


def whole_cifar_runs():
    """(name, run, config, the run's scorer, its solver's training rows)
    of the CIFAR entry points phase 33 calls as a user calls them,
    fitted whole on synthetic data at the script's counts, in one
    process and on the ranks; the rows (the run's own draws, placed on
    ``mesh``) for `unsplit_model`."""
    from keystone_tpu_torch.pipelines import cifar_variants as cv
    from keystone_tpu_torch.pipelines.random_patch_cifar import load_data

    counts = dict(num_filters=256, synth_train=N_TRAIN, synth_test=N_TEST)
    return (
        ("kernel", cv.run_random_patch_cifar_kernel,
         cv.RandomPatchCifarKernelConfig(
             gamma=2e-3, lam=10.0, kernel_block=2048, kernel_epochs=1,
             **counts), lambda r: r["predictor"],
         lambda c, mesh: load_data(c, "cuda", mesh)[0]),
        ("augmented", cv.run_random_patch_cifar_augmented,
         cv.RandomPatchCifarAugmentedConfig(**counts),
         lambda r: r["scorer"],
         lambda c, mesh: cv.random_crops(load_data(c, "cuda")[0], c, mesh)),
        ("augmented_kernel", cv.run_random_patch_cifar_augmented_kernel,
         cv.RandomPatchCifarAugmentedKernelConfig(
             gamma=2e-4, lam=10.0, kernel_block=2048, kernel_epochs=1,
             **counts), lambda r: r["scorer"],
         lambda c, mesh: cv.flipped_shuffled_crops(
             load_data(c, "cuda")[0], c, mesh)),
    )


def model_array(name: str, model) -> dict:
    """A fitted solver's model under ``name``: KRR's alpha (every
    training row), or BCD's W."""
    if hasattr(model, "alpha"):
        return {f"{name}_alpha": _krr_alpha(model)}
    return {f"{name}_W": model.W.cpu().numpy()}


def unsplit_model(name: str, scorer, train, config) -> dict:
    """``scorer``'s solver (`model_array`) refitted in this process on
    every row of its fit's inputs on the ranks, gathered: the scaled
    features (KRR's own ``train_X``; for BCD the scorer cut after its
    scaler, applied to ``train``) and ``train``'s label indicators. The
    ranks' data with the rows not split: against the ranks' model it
    shows what splitting the rows alone changes. For BCD, ``scorer``
    must have been fitted stage by stage (a cut of a pipeline fitted
    whole does not reproduce its fit's input)."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.block_ls import (
        BlockLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.kernels import (
        KernelRidgeRegression,
    )
    from keystone_tpu_torch.nodes.util.basic import (
        ClassLabelIndicatorsFromInt,
    )

    model = scorer.fitted(1)
    Y = ClassLabelIndicatorsFromInt(config.num_classes)(
        train.labels).get().numpy()
    if hasattr(model, "alpha"):
        X = _krr_rows(model)
        est = KernelRidgeRegression(model.gamma, config.lam,
                                    model.block_size, seed=config.seed)
    else:
        X = cut(scorer, 3)(train.data).get().numpy()
        est = BlockLeastSquaresEstimator(config.block_size, 1, config.lam)
    dev = train.data.device
    fitted = est.fit(Dataset(torch.from_numpy(X).to(dev)),
                     Dataset(torch.from_numpy(Y).to(dev)))
    return model_array(f"{name}_unsplit", fitted)


def whole_cifar_arrays(name, out, scorer) -> dict:
    """A whole run's test confusion and its model (`model_array`)."""
    return dict(model_array(f"whole_{name}", scorer(out).fitted(1)),
                **{f"whole_{name}_confusion": np.asarray(
                    out["test_confusion"])})


def voc_sideband_config(folder: str):
    """VOCSIFTFisher at phase 15's widths, its PCA and GMM read from the
    sideband CSVs in ``folder`` (`write_voc_sideband`)."""
    from keystone_tpu_torch.pipelines import voc_sift_fisher

    return voc_sift_fisher.VOCSIFTFisherConfig(
        num_classes=VOC_CLASSES, pca_dims=VOC_PCA_DIMS, gmm_k=VOC_GMM_K,
        **{f"{key}_file": os.path.join(folder, f"voc_{key}.csv")
           for key in ("pca", "gmm_mean", "gmm_var", "gmm_wts")})


def write_voc_sideband(folder: str) -> None:
    """Phase 15's fitted PCA and GMM as the reference's sideband CSVs:
    the PCA (k × d), the means and variances (d × clusters), the
    weights; written at full precision, so they load bit for bit."""
    ref = DATA_AXIS_REF
    for key, a in (("pca", ref["voc_pca"].T),
                   ("gmm_mean", ref["voc_gmm_means"].T),
                   ("gmm_var", ref["voc_gmm_variances"].T),
                   ("gmm_wts", ref["voc_gmm_weights"])):
        np.savetxt(os.path.join(folder, f"voc_{key}.csv"),
                   np.asarray(a, np.float64), delimiter=",")


def data_axis_one_process(folder: str) -> dict:
    """The one-process runs phase 33 holds its ranks' entry points to:
    the CIFAR entry points fitted whole (`whole_cifar_runs`) and
    VOCSIFTFisher from phase 15's PCA and GMM (BWLS alone); their
    arrays, seconds and storage trails."""
    from keystone_tpu_torch.pipelines import voc_sift_fisher
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.workflow import PipelineEnv

    arr, info = {}, {}
    for name, run, config, scorer, _ in whole_cifar_runs():
        PipelineEnv.reset()
        mark = ledger.session_mark()
        seconds, out = timed_s(lambda: run(config, "cuda"))
        arr.update(whole_cifar_arrays(name, out, scorer))
        info[f"whole_{name}"] = dict(seconds=seconds,
                                     test_accuracy=out["test_accuracy"],
                                     precision=precision_trails(mark))
        del out
        torch.cuda.empty_cache()
    write_voc_sideband(folder)
    config = voc_sideband_config(folder)
    vc_train = voc_sift_fisher._synthetic_voc(VOC_N_TRAIN, VOC_CLASSES,
                                              config.seed)
    vc_test = voc_sift_fisher._synthetic_voc(VOC_N_TEST, VOC_CLASSES,
                                             config.seed + 1)
    PipelineEnv.reset()
    mark = ledger.session_mark()
    vc = voc_sift_fisher.run_on(vc_train, vc_test, config, "cuda")
    arr.update(side_voc_W=vc["model"].predictor.fitted().W.cpu().numpy(),
               side_voc_scores=vc["scores"].numpy())
    info["side_voc"] = dict(seconds=vc["seconds"], map=vc["map"],
                            precision=precision_trails(mark))
    del vc
    PipelineEnv.reset()
    torch.cuda.empty_cache()
    return arr, info


def data_axis_rank(rank: int, port: int, out_dir: str) -> int:
    """One rank of phase 33: a gloo group of two ranks over the card's
    tensors, the (2, 1) mesh, RandomPatchCifarKernel, the augmented pair,
    VOCSIFTFisher and ImageNetSiftLcsFV on each rank's rows. Writes
    ``rank<r>.json`` and ``rank<r>.npz`` into ``out_dir``."""
    from keystone_tpu_torch import parallel
    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import (
        LabeledData,
        synthetic_cifar,
    )
    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.pipelines import (
        imagenet_sift_lcs_fv,
        voc_sift_fisher,
    )
    from keystone_tpu_torch.pipelines.cifar_variants import (
        RandomPatchCifarAugmentedConfig,
        RandomPatchCifarAugmentedKernelConfig,
        RandomPatchCifarKernelConfig,
        build_random_patch_cifar_augmented,
        build_random_patch_cifar_augmented_kernel,
        build_random_patch_cifar_kernel,
        flipped_shuffled_crops,
        random_crops,
        score_center_corner_views,
    )

    t0 = time.perf_counter()
    parallel.init_multihost(f"127.0.0.1:{port}", 2, rank, device="cuda",
                            timeout=DATA_AXIS_TIMEOUT_S, backend="gloo")
    res = dict(rank=rank, init_seconds=time.perf_counter() - t0)
    arr = {}
    try:
        mesh = parallel.global_data_mesh()
        res["shards"] = [parallel.n_data_shards(mesh),
                         parallel.n_model_shards(mesh)]
        kc_config = RandomPatchCifarKernelConfig(
            num_filters=256, gamma=2e-3, lam=10.0, kernel_block=2048,
            kernel_epochs=1)
        evaluator = MulticlassClassifierEvaluator(kc_config.num_classes)

        def placed(whole):
            """This rank's rows of a whole `LabeledData`, as
            `synthetic_cifar(..., mesh=mesh)` places them."""
            return LabeledData(
                labels=Dataset(whole.labels.array, mesh=mesh),
                data=Dataset(whole.data.array, mesh=mesh))

        def kernel_fit(train, test):
            # phase 6's order: the featurizer, the scaler's and the KRR's
            # fits, then the applies (the planners choose a graph's
            # storage precisions, so another order can plan the fit's
            # input otherwise)
            predictor = build_random_patch_cifar_kernel(train, kc_config)
            cut(predictor, 2)(train.data).get()
            predictor.fitted(0)
            predictor.fitted(1)
            train_metrics = evaluator(predictor(train.data), train.labels)
            preds = predictor(test.data).get()
            return (predictor, preds, train_metrics,
                    evaluator(preds, test.labels))

        def augmented_fit(augment, build, cfg, train, test, with_flips):
            # phases 10 and 11's order: the views drawn over the whole
            # training set and placed, the featurizer, the fits, the
            # training views' predict, then the test views
            views = augment(train, cfg, mesh)
            scorer = build(views, cfg)
            cut(scorer, 2)(views.data).get()
            scorer.fitted(0)
            scorer.fitted(1)
            train_metrics = evaluator((scorer >> MaxClassifier())(
                views.data), views.labels)
            test_metrics = score_center_corner_views(
                scorer, test, cfg, with_flips, mesh)
            return scorer, views, train_metrics, test_metrics

        vc_config = voc_sift_fisher.VOCSIFTFisherConfig(
            num_classes=VOC_CLASSES, pca_dims=VOC_PCA_DIMS, gmm_k=VOC_GMM_K)
        vc_train = voc_sift_fisher._synthetic_voc(VOC_N_TRAIN, VOC_CLASSES,
                                                  vc_config.seed)
        vc_test = voc_sift_fisher._synthetic_voc(VOC_N_TEST, VOC_CLASSES,
                                                 vc_config.seed + 1)
        im_config = imagenet_sift_lcs_fv.ImageNetSiftLcsFVConfig()
        im_train = imagenet_sift_lcs_fv._synthetic_imagenet(
            IMAGENET_N_TRAIN, im_config.num_classes, im_config.seed)
        im_test = imagenet_sift_lcs_fv._synthetic_imagenet(
            IMAGENET_N_TEST, im_config.num_classes, im_config.seed + 1)
        # every rank draws the whole arrays, as one process does
        t0 = time.perf_counter()
        whole_train, whole_test = synthetic_cifar(
            N_TRAIN, N_TEST, noise=1.2, confusion=0.6, device="cuda")
        train, test = placed(whole_train), placed(whole_test)
        res["data_seconds"] = time.perf_counter() - t0

        # a warm run at a tenth of the counts (VOC at 16 components, so
        # its solve is small): a fresh process's first launches, meta
        # traces and gloo buffers, outside the clocks
        t0 = time.perf_counter()
        kernel_fit(placed(LabeledData(
            labels=Dataset(whole_train.labels.array[:N_TRAIN // 10]),
            data=Dataset(whole_train.data.array[:N_TRAIN // 10]))),
            placed(LabeledData(
                labels=Dataset(whole_test.labels.array[:N_TEST // 10]),
                data=Dataset(whole_test.data.array[:N_TEST // 10]))))
        voc_sift_fisher.run_on(
            HostDataset(vc_train.items[:SIFT_FISHER_WARM]),
            HostDataset(vc_test.items[:SIFT_FISHER_WARM]),
            voc_sift_fisher.VOCSIFTFisherConfig(
                num_classes=VOC_CLASSES, pca_dims=VOC_PCA_DIMS, gmm_k=16),
            "cuda", mesh)
        torch.cuda.synchronize()
        res["warm_seconds"] = time.perf_counter() - t0

        predictor, preds, train_metrics, test_metrics = _data_axis_run(
            "kernel", lambda: kernel_fit(train, test), res)
        res["kernel"].update(train_error=train_metrics.error,
                             test_accuracy=test_metrics.accuracy)
        model = predictor.fitted(1)
        arr["kernel_preds"] = preds.numpy()
        arr["kernel_alpha"] = _krr_alpha(model)
        arr.update(unsplit_model("kernel", predictor, train, kc_config))
        del predictor, preds, model, train, test

        for name, augment, build, cfg, flips in (
                ("augmented", random_crops,
                 build_random_patch_cifar_augmented,
                 RandomPatchCifarAugmentedConfig(num_filters=256), False),
                ("augmented_kernel", flipped_shuffled_crops,
                 build_random_patch_cifar_augmented_kernel,
                 RandomPatchCifarAugmentedKernelConfig(
                     num_filters=256, gamma=2e-4, lam=10.0,
                     kernel_block=2048, kernel_epochs=1), True)):
            scorer, views, train_metrics, test_metrics = _data_axis_run(
                name, lambda: augmented_fit(augment, build, cfg,
                                            whole_train, whole_test, flips),
                res)
            res[name].update(train_views=views.data.count,
                             train_error=train_metrics.error,
                             test_accuracy=test_metrics.accuracy)
            arr[f"{name}_confusion"] = np.asarray(test_metrics.confusion)
            arr.update(model_array(name, scorer.fitted(1)))
            arr.update(unsplit_model(name, scorer, views, cfg))
            del scorer, views
        del whole_train, whole_test

        vc = _data_axis_run("voc", lambda: voc_sift_fisher.run_on(
            vc_train, vc_test, vc_config, "cuda", mesh), res)
        res["voc"].update(map=vc["map"], run_seconds=vc["seconds"],
                          pca=pca_routes(vc["model"].predictor))
        model = vc["model"]
        arr["voc_scores"] = vc["scores"].numpy()
        arr["voc_W"] = model.predictor.fitted().W.cpu().numpy()
        arr["voc_pca"] = model.pca.fitted().components.cpu().numpy()
        arr["voc_gmm_means"] = model.fisher.fitted().gmm.means.cpu().numpy()
        del vc, model

        im = _data_axis_run("imagenet", lambda: imagenet_sift_lcs_fv.run_on(
            im_train, im_test, im_config, "cuda", mesh), res)
        res["imagenet"].update(test_accuracy=im["test_accuracy"],
                               run_seconds=im["seconds"],
                               pca=pca_routes(im["predictor"]))
        arr["imagenet_preds"] = im["predictions"].numpy()
        arr["imagenet_W"] = im["predictor"].fitted().W.cpu().numpy()
        del im

        # BWLS alone: VOC from phase 15's PCA and GMM, written by the
        # parent into ``out_dir``
        vc = _data_axis_run("side_voc", lambda: voc_sift_fisher.run_on(
            vc_train, vc_test, voc_sideband_config(out_dir), "cuda", mesh),
            res)
        res["side_voc"].update(map=vc["map"])
        arr["side_voc_W"] = vc["model"].predictor.fitted().W.cpu().numpy()
        arr["side_voc_scores"] = vc["scores"].numpy()
        del vc

        # the CIFAR entry points as a user calls them on the mesh
        for name, run, config, scorer, rows in whole_cifar_runs():
            out = _data_axis_run(f"whole_{name}",
                                 lambda: run(config, "cuda", mesh), res)
            res[f"whole_{name}"].update(test_accuracy=out["test_accuracy"])
            arr.update(whole_cifar_arrays(name, out, scorer))
            if hasattr(scorer(out).fitted(1), "alpha"):
                # KRR keeps its fit's rows; a pipeline fitted whole
                # gives no cut that reproduces BCD's input
                arr.update(unsplit_model(f"whole_{name}", scorer(out),
                                         rows(config, mesh), config))
            del out
        parallel.barrier()
    finally:
        parallel.reset_default_mesh()
        import torch.distributed as dist

        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arr)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def data_axis_phase(card) -> dict:
    """33. data_axis: two ranks on the card, a gloo group over its
    tensors on the (2, 1) mesh, the image estimators across ranks, held
    to the one-process phases of this run (`DATA_AXIS_REF`)."""
    import socket

    phase_t0 = time.perf_counter()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as tmp:
        one_arr, one_info = data_axis_one_process(tmp)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--data-axis-rank",
             str(r), "--data-axis-port", str(port), "--data-axis-out",
             tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DATA_AXIS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"data_axis: rank {r} exited "
                  f"{p.returncode}:\n{logs[r][-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            ranks.append((res, dict(np.load(os.path.join(
                tmp, f"rank{r}.npz")))))
    ranks_equal = {key: bool(np.array_equal(ranks[0][1][key],
                                            ranks[1][1][key]))
                   for key in ranks[0][1]}
    ref = dict(DATA_AXIS_REF, **one_arr)
    arr = ranks[0][1]
    out = {"ranks": [res for res, _ in ranks]}

    def rel(key, other=None):
        """max|a − b| of ``key`` as a share of max|b|."""
        b = ref[key] if other is None else other
        return float(np.abs(arr[key] - b).max() / np.abs(b).max())

    def moved(key):
        """Test predictions a confusion's entries moved: half the sum of
        their changes, a prediction taken from one cell to another."""
        return int(np.abs(arr[key].astype(np.int64)
                          - np.asarray(ref[key], np.int64)).sum() // 2)

    alpha_err = {key: rel(f"{key}_alpha")
                 for key in ("kernel", "augmented_kernel", "whole_kernel",
                             "whole_augmented_kernel")}
    alpha_tol = dict(kernel=DATA_AXIS_ALPHA_RTOL,
                     whole_kernel=DATA_AXIS_ALPHA_RTOL,
                     augmented_kernel=DATA_AXIS_AUG_ALPHA_RTOL,
                     whole_augmented_kernel=DATA_AXIS_AUG_ALPHA_RTOL)
    # the ranks' alpha against a fit of the ranks' own rows in one
    # process (only the split differs), and that fit against the
    # one-process phase's (only the data upstream of KRR differs)
    bcd_w_err = {key: rel(f"{key}_W")
                 for key in ("augmented", "whole_augmented")}
    split, upstream = {}, {}
    for key in [f"{k}_alpha" for k in alpha_err] + [
            f"{k}_W" for k in bcd_w_err]:
        unsplit = arr.get(key.replace("_alpha", "_unsplit_alpha")
                          .replace("_W", "_unsplit_W"))
        if unsplit is not None:
            split[key] = rel(key, unsplit)
            upstream[key] = float(np.abs(unsplit - ref[key]).max()
                                  / np.abs(ref[key]).max())
    differ = int((arr["kernel_preds"] != ref["kernel_preds"]).sum())
    im_differ = int((arr["imagenet_preds"] != ref["imagenet_preds"]).sum())
    confusion_moved = {key: moved(f"{key}_confusion")
                       for key in ("augmented", "augmented_kernel",
                                   "whole_kernel", "whole_augmented",
                                   "whole_augmented_kernel")}
    bwls_w_err, bwls_score_err = rel("side_voc_W"), rel("side_voc_scores")
    voc_w_err, voc_score_err = rel("voc_W"), rel("voc_scores")
    # the PCA's components up to each column's sign
    signs = np.sign((arr["voc_pca"] * ref["voc_pca"]).sum(axis=0))
    voc_pca_err = float(np.abs(arr["voc_pca"] * signs - ref["voc_pca"]).max())
    voc_gmm_err = rel("voc_gmm_means")
    runs = ("kernel", "augmented", "augmented_kernel", "voc", "imagenet",
            "side_voc", "whole_kernel", "whole_augmented",
            "whole_augmented_kernel")
    one_process = {k: v for k, v in ref.items()
                   if not isinstance(v, np.ndarray)}
    one_process.update(one_info)
    out.update(
        ranks_equal=ranks_equal, alpha_rel_err=alpha_err,
        bcd_W_rel_err=bcd_w_err, model_rel_err_of_the_split=split,
        model_rel_err_upstream=upstream,
        kernel_rows_differing=differ, imagenet_rows_differing=im_differ,
        confusion_predictions_moved=confusion_moved,
        bwls_alone=dict(W_rel_err=bwls_w_err, scores_rel_err=bwls_score_err,
                        one_process_sideband_W_rel_to_phase_15=float(
                            np.abs(one_arr["side_voc_W"] - ref["voc_W"]).max()
                            / np.abs(ref["voc_W"]).max())),
        voc_W_rel_err=voc_w_err, voc_scores_rel_err=voc_score_err,
        voc_pca_abs_err=voc_pca_err, voc_gmm_means_rel_err=voc_gmm_err,
        imagenet_W_rel_err=rel("imagenet_W"),
        precision={name: dict(
            one_process=(one_info.get(name) or {}).get(
                "precision", ref.get(f"{name}_precision")),
            ranks=[res[name]["precision"] for res, _ in ranks])
            for name in runs},
        one_process=one_process,
        collective_seconds_are=(
            "gloo over the card's tensors, through host memory: not "
            "an NVLink or multi-card figure"))
    out["phase_seconds"] = time.perf_counter() - phase_t0
    phase("data_axis", **out, card=card)
    for key, equal in ranks_equal.items():
        check(equal, f"data_axis: {key} differs between the ranks")
    for key, err in alpha_err.items():
        check(err <= alpha_tol[key], f"data_axis {key}: KRR's alpha "
              f"{err} of max|alpha| from one process's (at most "
              f"{alpha_tol[key]})")
    for key, err in bcd_w_err.items():
        tol = (DATA_AXIS_WHOLE_BCD_W_RTOL if key.startswith("whole_")
               else DATA_AXIS_BCD_W_RTOL)
        check(err <= tol, f"data_axis {key}: BCD's W {err} of max|W| from "
              f"one process's (at most {tol})")
    check(differ <= DATA_AXIS_PRED_DIFF, f"data_axis: {differ} kernel test "
          f"predictions differ from phase 6's (at most "
          f"{DATA_AXIS_PRED_DIFF})")
    check(im_differ <= DATA_AXIS_IMAGENET_PRED_DIFF, f"data_axis: "
          f"{im_differ} ImageNet test predictions differ from phase 16's "
          f"(at most {DATA_AXIS_IMAGENET_PRED_DIFF})")
    for key, n in confusion_moved.items():
        check(n <= DATA_AXIS_PRED_DIFF, f"data_axis {key}: {n} test "
              f"predictions moved in the confusion from one process's (at "
              f"most {DATA_AXIS_PRED_DIFF})")
    check(bwls_w_err <= DATA_AXIS_BWLS_RTOL and bwls_score_err
          <= DATA_AXIS_BWLS_RTOL, f"data_axis: BWLS alone, W {bwls_w_err} "
          f"and scores {bwls_score_err} of their max from one process's "
          f"(at most {DATA_AXIS_BWLS_RTOL})")
    check(voc_pca_err <= DATA_AXIS_PCA_ATOL, f"data_axis: VOC's PCA "
          f"components {voc_pca_err} from phase 15's (at most "
          f"{DATA_AXIS_PCA_ATOL})")
    check(voc_gmm_err <= DATA_AXIS_GMM_RTOL, f"data_axis: VOC's GMM means "
          f"{voc_gmm_err} of their max from phase 15's (at most "
          f"{DATA_AXIS_GMM_RTOL})")
    check(voc_w_err <= DATA_AXIS_W_RTOL, f"data_axis: VOC's W {voc_w_err} "
          f"of max|W| from phase 15's (at most {DATA_AXIS_W_RTOL})")
    check(voc_score_err <= DATA_AXIS_SCORE_RTOL, f"data_axis: VOC's test "
          f"scores {voc_score_err} of max|score| from phase 15's (at most "
          f"{DATA_AXIS_SCORE_RTOL})")
    for res, _ in ranks:
        r = res["rank"]
        kc_blocks = math.ceil(N_TRAIN / 2048)
        # the fit's blocks, then the train and test applies' blocks
        for name in ("kernel", "whole_kernel"):
            check(res[name]["launches"]["rbf_block"] == 3 * kc_blocks,
                  f"data_axis: rank {r} launched K5 "
                  f"{res[name]['launches']['rbf_block']} times in {name}, "
                  f"not {3 * kc_blocks}")
        for name in ("kernel", "augmented", "augmented_kernel",
                     "whole_kernel", "whole_augmented",
                     "whole_augmented_kernel"):
            check(res[name]["launches"]["conv_rectify_pool"] > 0,
                  f"data_axis: rank {r} launched no K1 in {name}")
        for name in ("augmented_kernel", "whole_augmented_kernel"):
            check(res[name]["launches"]["rbf_block"] > 0,
                  f"data_axis: rank {r} launched no K5 in {name}")
        for name in ("voc", "imagenet", "side_voc"):
            check(res[name]["launches"]["elementwise_chain"] > 0,
                  f"data_axis: rank {r} launched no K4 in {name}")
        for name, want in (
                ("kernel", ref["kernel_accuracy"]),
                ("augmented", ref["augmented_accuracy"]),
                ("augmented_kernel", ref["augmented_kernel_accuracy"]),
                ("imagenet", ref["imagenet_accuracy"]),
                ("whole_kernel", one_info["whole_kernel"]["test_accuracy"]),
                ("whole_augmented",
                 one_info["whole_augmented"]["test_accuracy"]),
                ("whole_augmented_kernel",
                 one_info["whole_augmented_kernel"]["test_accuracy"])):
            acc = res[name]["test_accuracy"]
            check(abs(acc - want) <= DATA_AXIS_ACC_TOL,
                  f"data_axis {name}: rank {r} accuracy {acc}, one "
                  f"process's {want}")
        for name, want in (("voc", ref["voc_map"]),
                           ("side_voc", one_info["side_voc"]["map"])):
            check(abs(res[name]["map"] - want) <= DATA_AXIS_MAP_TOL,
                  f"data_axis {name}: rank {r} mAP {res[name]['map']}, one "
                  f"process's {want}")
        for name in runs:
            check(any(k.startswith("collectives.data.")
                      for k in res[name]["counters"]),
                  f"data_axis {name}: rank {r} ran no collective over data")
    return {name: [res[name]["launches"] for res, _ in ranks]
            for name in runs}


def amazon_indicators(y) -> np.ndarray:
    """±1 indicators of Amazon's two classes, (n, 2) float32: the labels
    of the sparse least-squares fits of phases 21 and 34."""
    Y = -np.ones((len(y), 2), np.float32)
    Y[np.arange(len(y)), np.asarray(y, np.int64)] = 1.0
    return Y


def text_axis_sparse_reference(amazon) -> None:
    """One process's `SparseLBFGSwithL2` on phase 18's Amazon training
    CSR at phase 21's λ and steps, its iterative route: W, b and the
    objective after each step, into `TEXT_AXIS_REF`."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2

    est = SparseLBFGSwithL2(SPARSE_LAM, SPARSE_ITERS, method="iterative")
    model = est.fit(amazon["train"], Dataset(amazon_indicators(
        amazon["train_labels"]), device="cuda"))
    TEXT_AXIS_REF.update(sparse_W=model.W.cpu().numpy(),
                         sparse_b=model.b.cpu().numpy(),
                         sparse_history=est.loss_history.numpy())


def _dense_fits(place):
    """ZCA, the approximate PCA, the dual least squares and LDA on the
    inputs (and at the sizes) of their JAX tests (`tests/test_images.py`,
    `test_unsupervised.py`, `test_solvers.py`, `test_breadth.py`), each
    input made a `Dataset` by ``place``: name → array."""
    from keystone_tpu_torch.nodes.learning import (
        ApproximatePCAEstimator,
        LinearDiscriminantAnalysis,
        LocalLeastSquaresEstimator,
        ZCAWhitenerEstimator,
    )

    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 4)).astype(np.float32)
    Xz = (rng.normal(size=(2000, 4)) @ A).astype(np.float32)
    rng = np.random.default_rng(0)
    U = rng.normal(size=(2000, 3)).astype(np.float32)
    B = rng.normal(size=(3, 12)).astype(np.float32)
    Xp = U @ B + 0.05 * rng.normal(size=(2000, 12)).astype(np.float32)
    rng = np.random.default_rng(0)
    Xl = rng.normal(size=(40, 200)).astype(np.float32)
    Yl = rng.normal(size=(40, 2)).astype(np.float32)
    rng = np.random.default_rng(6)
    Xd = np.concatenate([rng.normal([0, 0, 0], 1, (80, 3)),
                         rng.normal([5, 5, 0], 1, (80, 3))]).astype(
        np.float32)
    yd = np.array([0] * 80 + [1] * 80, np.int32)
    zca = ZCAWhitenerEstimator(eps=1e-5).fit(place(Xz))
    out = dict(
        zca_whitener=zca.whitener, zca_means=zca.means,
        approx_pca=ApproximatePCAEstimator(3, oversample=8, q=2).fit(
            place(Xp)).components,
        local_ls=LocalLeastSquaresEstimator(3.0).fit(place(Xl),
                                                     place(Yl)).W,
        lda=LinearDiscriminantAnalysis(1).fit(place(Xd),
                                              place(yd)).components)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _kgen_rows():
    """The kernel generator's whole anchors (4,096 a rank) and apply rows
    (25,000 a rank), drawn on the card from fixed seeds, so every
    process draws the same ones."""
    def draw(n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn((n, KGEN_D), generator=g, device="cuda") \
            / math.sqrt(KGEN_D)

    return draw(2 * KGEN_ANCHORS, 101), draw(2 * KGEN_ROWS, 102)


def text_axis_rank(rank: int, port: int, out_dir: str) -> int:
    """One rank of phase 34: a gloo group of two ranks over the card's
    tensors, the (2, 1) mesh, the text pipelines, the sparse fit,
    stupid backoff, the kernel generator and the dense fits on each
    rank's rows. Writes ``rank<r>.json`` and ``rank<r>.npz`` into
    ``out_dir``."""
    from keystone_tpu_torch import parallel
    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.nodes.learning import GaussianKernelGenerator
    from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.pipelines import text_pipelines as tp
    from keystone_tpu_torch.workflow import PipelineEnv

    t0 = time.perf_counter()
    parallel.init_multihost(f"127.0.0.1:{port}", 2, rank, device="cuda",
                            timeout=TEXT_AXIS_TIMEOUT_S, backend="gloo")
    res = dict(rank=rank, init_seconds=time.perf_counter() - t0)
    arr = {}
    try:
        mesh = parallel.global_data_mesh()
        res["shards"] = [parallel.n_data_shards(mesh),
                         parallel.n_model_shards(mesh)]
        news_config = tp.NewsgroupsConfig(num_classes=NEWS_CLASSES,
                                          common_features=TEXT_FEATURES)
        amazon_config = tp.AmazonReviewsConfig(common_features=TEXT_FEATURES,
                                               lam=AMAZON_LAM)
        t0 = time.perf_counter()
        news_sets = (*tp.synthetic_corpus(NEWS_N_TRAIN, NEWS_CLASSES,
                                          seed=0),
                     *tp.synthetic_corpus(NEWS_N_TEST, NEWS_CLASSES, seed=1))
        am_labels, am_docs = tp.synthetic_corpus(AMAZON_N, 2, seed=0)
        _, backoff_docs = tp.synthetic_corpus(BACKOFF_N, 2, seed=0)
        res["data_seconds"] = time.perf_counter() - t0

        # a warm run on a few documents: a fresh process's first
        # products, CSR copies and gloo buffers, outside the clocks
        t0 = time.perf_counter()
        few = [HostDataset(d.items[:TEXT_WARM]) for d in news_sets]
        tp.run_newsgroups_on(*few, NEWS_CLASSES, news_config, "cuda", mesh)
        tp.run_amazon_on(HostDataset(am_labels.items[:2 * TEXT_WARM]),
                         HostDataset(am_docs.items[:2 * TEXT_WARM]),
                         amazon_config, "cuda", mesh)
        torch.cuda.synchronize()
        res["warm_seconds"] = time.perf_counter() - t0

        def news():
            return tp.run_newsgroups_on(*news_sets, NEWS_CLASSES,
                                        news_config, "cuda", mesh)

        def amazon():
            return tp.run_amazon_on(am_labels, am_docs, amazon_config,
                                    "cuda", mesh)

        # untraced first: a trace sizes every host item a stage emits
        # (`telemetry/instrument.py::estimate_bytes`), which the text
        # stages' token lists make costly
        for name, run in (("newsgroups", news), ("amazon", amazon)):
            PipelineEnv.reset()
            seconds, out = timed_s(run)
            res[f"{name}_untraced"] = dict(seconds=seconds,
                                           run_seconds=out["seconds"])
            del out
        nw = _data_axis_run("newsgroups", news, res)
        nb = nw["model"].classifier.fitted()
        res["newsgroups"].update(
            vocab=vocab_digest(nw["model"].vocabulary.fitted().vocab),
            test_accuracy=nw["test_accuracy"], run_seconds=nw["seconds"])
        arr.update(news_log_priors=nb.log_priors.cpu().numpy(),
                   news_log_cond=nb.log_cond.cpu().numpy(),
                   news_preds=nw["predictions"].numpy())
        del nw, nb

        am = _data_axis_run("amazon", amazon, res)
        model = am["model"]
        res["amazon"].update(
            vocab=vocab_digest(model.vocabulary.fitted().vocab),
            test_accuracy=am["test_accuracy"], f1=am["f1"],
            run_seconds=am["seconds"],
            linesearch_evals=sum(am["estimator"].linesearch_steps))
        arr.update(amazon_W=model.classifier.fitted().W.cpu().numpy(),
                   amazon_preds=am["predictions"].numpy())
        X = model.vectorizer(model.train_docs).get()
        n_train = int(0.8 * AMAZON_N)
        y = np.asarray(am_labels.items[:n_train], np.int64)
        Y = Dataset(amazon_indicators(y), device="cuda", mesh=mesh)
        res["amazon"].update(
            train_rows=[X.count, X.total, X.first_row],
            objective=objective64(X.gather(), y, arr["amazon_W"],
                                  AMAZON_LAM))
        del am, model

        est = SparseLBFGSwithL2(SPARSE_LAM, SPARSE_ITERS)
        sparse = _data_axis_run("sparse_lbfgs", lambda: est.fit(X, Y), res)
        res["sparse_lbfgs"]["route"] = est.route
        arr.update(sparse_W=sparse.W.cpu().numpy(),
                   sparse_b=sparse.b.cpu().numpy(),
                   sparse_history=est.loss_history.numpy())
        del X, Y, sparse

        sb = _data_axis_run("stupid_backoff", lambda: tp.run_stupid_backoff_on(
            backoff_docs, mesh), res)
        res["stupid_backoff"].update({k: sb[k] for k in (
            "vocab", "num_trigrams", "mean_log_score")})

        anchors, rows = _kgen_rows()
        out = _data_axis_run("kernel_generator", lambda: (
            GaussianKernelGenerator(KGEN_GAMMA).fit(
                Dataset(anchors, mesh=mesh))
            .apply_batch(Dataset(rows, mesh=mesh)).array), res)
        mine = rows[rank * KGEN_ROWS:(rank + 1) * KGEN_ROWS]
        want = kernels.rbf_block_reference(mine, anchors, KGEN_GAMMA)
        # one process's fit of the whole rows, this rank's rows of it
        one = GaussianKernelGenerator(KGEN_GAMMA).fit(Dataset(anchors)) \
            .apply_batch(Dataset(rows)).array[
                rank * KGEN_ROWS:(rank + 1) * KGEN_ROWS]
        res["kernel_generator"].update(
            shape=list(out.shape),
            max_abs_err=float((out - want).abs().max()),
            one_process_max_abs_diff=float((out - one).abs().max()))
        del out, want, one, anchors, rows, mine

        dense = _data_axis_run("dense", lambda: _dense_fits(
            lambda x: Dataset.from_numpy(x, mesh=mesh)), res)
        arr.update(dense)
        one = _dense_fits(lambda x: Dataset(x, device="cuda"))
        res["dense"]["rel_diff"] = {
            k: float(np.abs(dense[k] - one[k]).max()
                     / max(np.abs(one[k]).max(), 1e-30)) for k in dense}
        parallel.barrier()
    finally:
        parallel.reset_default_mesh()
        import torch.distributed as dist

        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arr)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def text_axis_phase(card) -> dict:
    """34. text_axis: two ranks on the card, a gloo group over its
    tensors on the (2, 1) mesh, the text side of the data axis, held to
    the one-process phases of this run (`TEXT_AXIS_REF`)."""
    import socket

    phase_t0 = time.perf_counter()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--text-axis-rank",
             str(r), "--text-axis-port", str(port), "--text-axis-out",
             tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TEXT_AXIS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"text_axis: rank {r} exited "
                  f"{p.returncode}:\n{logs[r][-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            ranks.append((res, dict(np.load(os.path.join(
                tmp, f"rank{r}.npz")))))
    ranks_equal = {key: bool(np.array_equal(ranks[0][1][key],
                                            ranks[1][1][key]))
                   for key in ranks[0][1]}
    ref, arr = TEXT_AXIS_REF, ranks[0][1]

    def rel(key):
        """max|a − b| of ``key`` as a share of max|b|."""
        return float(np.abs(arr[key] - ref[key]).max()
                     / np.abs(ref[key]).max())

    news_differ = int((arr["news_preds"] != ref["news_preds"]).sum())
    amazon_moved = int((arr["amazon_preds"] != ref["amazon_preds"]).sum())
    last = float(arr["sparse_history"][-1])
    ref_last = float(ref["sparse_history"][-1])
    sparse_objective_rel = abs(last / ref_last - 1.0)
    runs = ("newsgroups", "amazon", "sparse_lbfgs", "stupid_backoff",
            "kernel_generator", "dense")
    per_rank = {name: [dict(
        seconds=res[name]["seconds"],
        untraced_seconds=res.get(f"{name}_untraced", {}).get("seconds"),
        data_bytes={k[len("collectives.data."):]: v
                    for k, v in res[name]["counters"].items()
                    if k.startswith("collectives.data.")},
        collectives=res[name]["collectives"],
        peak_bytes=res[name]["peak_bytes"],
        k5=dict(products=res[name]["launches"]["rbf_block"],
                prepasses=res[name]["launches"]["rbf_split"]))
        for res, _ in ranks] for name in runs}
    out = dict(
        ranks=[res for res, _ in ranks], per_rank=per_rank,
        ranks_equal=ranks_equal,
        news_log_cond_rel_err=rel("news_log_cond"),
        news_log_priors_equal=bool(np.array_equal(arr["news_log_priors"],
                                                  ref["news_log_priors"])),
        news_test_rows_differing=news_differ,
        amazon_W_rel_err=rel("amazon_W"),
        amazon_test_predictions_moved=amazon_moved,
        sparse_W_rel_err=rel("sparse_W"), sparse_b_rel_err=rel("sparse_b"),
        sparse_last_objective=last, sparse_last_objective_one_process=ref_last,
        sparse_objective_rel_err=sparse_objective_rel,
        one_process={k: v for k, v in ref.items()
                     if not isinstance(v, np.ndarray)},
        collective_seconds_are=(
            "gloo over the card's tensors, through host memory: not "
            "an NVLink or multi-card figure"))
    out["phase_seconds"] = time.perf_counter() - phase_t0
    phase("text_axis", **out, card=card)
    for key, equal in ranks_equal.items():
        check(equal, f"text_axis: {key} differs between the ranks")
    check(out["news_log_priors_equal"], "text_axis: Newsgroups' log-priors "
          "differ from phase 17's")
    check(out["news_log_cond_rel_err"] <= TEXT_AXIS_NB_RTOL,
          f"text_axis: Newsgroups' log-conditionals "
          f"{out['news_log_cond_rel_err']} of their max from phase 17's (at "
          f"most {TEXT_AXIS_NB_RTOL})")
    check(news_differ == 0, f"text_axis: {news_differ} Newsgroups test "
          "predictions differ from phase 17's")
    check(amazon_moved <= TEXT_AXIS_AMAZON_MOVED, f"text_axis: "
          f"{amazon_moved} Amazon test predictions moved from phase 18's "
          f"(at most {TEXT_AXIS_AMAZON_MOVED})")
    check(out["sparse_W_rel_err"] <= TEXT_AXIS_SPARSE_W_RTOL, f"text_axis: "
          f"the sparse fit's W {out['sparse_W_rel_err']} of max|W| from one "
          f"process's (at most {TEXT_AXIS_SPARSE_W_RTOL})")
    check(sparse_objective_rel <= TEXT_AXIS_SPARSE_OBJECTIVE_RTOL,
          f"text_axis: the sparse fit's last objective {last}, one "
          f"process's {ref_last} (at most {TEXT_AXIS_SPARSE_OBJECTIVE_RTOL} "
          "relative)")
    for res, _ in ranks:
        r = res["rank"]
        check(res["shards"] == [2, 1], f"text_axis: rank {r} on a "
              f"{res['shards']} mesh")
        check(res["newsgroups"]["vocab"] == ref["news_vocab"],
              f"text_axis: rank {r}'s Newsgroups vocabulary differs from "
              "phase 17's")
        check(res["newsgroups"]["test_accuracy"] == ref["news_accuracy"],
              f"text_axis: rank {r}'s Newsgroups accuracy "
              f"{res['newsgroups']['test_accuracy']}, phase 17's "
              f"{ref['news_accuracy']}")
        check(res["amazon"]["vocab"] == ref["amazon_vocab"],
              f"text_axis: rank {r}'s Amazon vocabulary differs from phase "
              "18's")
        objective = res["amazon"]["objective"]
        check(abs(objective / ref["amazon_objective"] - 1.0)
              <= AMAZON_OBJECTIVE_RTOL, f"text_axis: rank {r}'s Amazon "
              f"objective {objective}, phase 18's "
              f"{ref['amazon_objective']} (at most {AMAZON_OBJECTIVE_RTOL} "
              "relative)")
        for key, name in (("test_accuracy", "amazon_accuracy"),
                          ("f1", "amazon_f1")):
            check(res["amazon"][key] == ref[name], f"text_axis: rank {r}'s "
                  f"Amazon {key} {res['amazon'][key]}, phase 18's "
                  f"{ref[name]}")
        check(res["sparse_lbfgs"]["route"] == "iterative", f"text_axis: "
              f"rank {r}'s sparse fit took the {res['sparse_lbfgs']['route']}"
              " route")
        sb, want = res["stupid_backoff"], ref["backoff"]
        check(sb["vocab"] == want["vocab"]
              and sb["num_trigrams"] == want["num_trigrams"]
              and abs(sb["mean_log_score"] - want["mean_log_score"])
              <= BACKOFF_TOL, f"text_axis: rank {r}'s backoff {sb}, phase "
              f"19's {want}")
        kg = res["kernel_generator"]
        check(kg["shape"] == [KGEN_ROWS, 2 * KGEN_ANCHORS],
              f"text_axis: rank {r}'s kernel rows {kg['shape']}")
        check(kg["max_abs_err"] <= K5_TOL and kg["one_process_max_abs_diff"]
              <= K5_TOL, f"text_axis: rank {r}'s K5 rows {kg['max_abs_err']}"
              f" from rbf_block_reference and "
              f"{kg['one_process_max_abs_diff']} from one process's (at most "
              f"{K5_TOL})")
        check(kg["launches"]["rbf_block"] > 0, f"text_axis: rank {r} "
              "launched no K5 in the kernel generator's apply")
        for key, err in res["dense"]["rel_diff"].items():
            check(err <= TEXT_AXIS_DENSE_RTOL, f"text_axis: rank {r}'s {key} "
                  f"{err} of its max from one process's (at most "
                  f"{TEXT_AXIS_DENSE_RTOL})")
        for name in runs:
            check(any(k.startswith("collectives.data.")
                      for k in res[name]["counters"]),
                  f"text_axis {name}: rank {r} ran no collective over data")
    return {name: [dict(products=res[name]["launches"]["rbf_block"],
                        prepasses=res[name]["launches"]["rbf_split"])
                   for res, _ in ranks] for name in ("kernel_generator",)}


def main() -> int:
    global SWAP_REPEATS
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on "
                                     "one NVIDIA Hopper card.")
    parser.add_argument("--swap-repeats", type=int, default=SWAP_REPEATS,
                        help="hot swaps in the serving phase after the "
                        "first, each to a fresh load of the other version")
    parser.add_argument("--model-axis-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--model-axis-port", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--model-axis-out", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--data-axis-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--data-axis-port", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--data-axis-out", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--text-axis-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--text-axis-port", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--text-axis-out", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    SWAP_REPEATS = args.swap_repeats
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.model_axis_rank is not None:  # one rank of phase 32
        return model_axis_rank(args.model_axis_rank, args.model_axis_port,
                               args.model_axis_out)
    if args.data_axis_rank is not None:  # one rank of phase 33
        return data_axis_rank(args.data_axis_rank, args.data_axis_port,
                              args.data_axis_out)
    if args.text_axis_rank is not None:  # one rank of phase 34
        return text_axis_rank(args.text_axis_rank, args.text_axis_port,
                              args.text_axis_out)
    script_t0 = time.perf_counter()
    import torch.nn.functional as F

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.device import resolve_device
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
        Pooler,
        SymmetricRectifier,
    )
    from keystone_tpu_torch.nodes.stats.normalization import (
        NormalizeRows,
        SignedHellingerMapper,
    )
    from keystone_tpu_torch.nodes.util.basic import MatrixVectorizer
    from keystone_tpu_torch.nodes.util.fusion import (
        FusedBatchTransformer,
        _GatherConcatStage,
        stage_fuse,
    )
    from keystone_tpu_torch.ops import _build, chain_kernels, kernels
    from keystone_tpu_torch.telemetry import ledger
    from keystone_tpu_torch.utils.images import GRAY_WEIGHTS
    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.pipelines.cifar_variants import (
        LINEAR_PIXELS_MICROBATCH,
        LinearPixelsConfig,
        RandomCifarConfig,
        RandomPatchCifarAugmentedConfig,
        RandomPatchCifarAugmentedKernelConfig,
        RandomPatchCifarKernelConfig,
        build_linear_pixels,
        build_random_cifar,
        build_random_patch_cifar_augmented,
        build_random_patch_cifar_augmented_kernel,
        build_random_patch_cifar_kernel,
        flipped_shuffled_crops,
        random_crops,
        score_center_corner_views,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        build_pipeline,
        run_fused,
        run_staged,
    )
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.nodes.learning.block_ls import (
        BlockLinearMapper,
        bcd_fit,
        raise_if_unfactored,
    )
    from keystone_tpu_torch.nodes.learning.lbfgs import DenseLBFGSwithL2
    from keystone_tpu_torch.nodes.learning.linear import (
        LocalLeastSquaresEstimator,
        normal_equations,
    )
    from keystone_tpu_torch.nodes.util.basic import ClassLabelIndicatorsFromInt
    from keystone_tpu_torch.pipelines import (
        imagenet_sift_lcs_fv,
        mnist_random_fft,
        timit,
    )
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.env import config_override
    from keystone_tpu_torch.workflow.executor import drain_warmups
    from keystone_tpu_torch.workflow.fusion_rule import NodeFusionRule

    # ---- 1. device -------------------------------------------------------
    dev = resolve_device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, name=name,
          count=torch.cuda.device_count(),
          tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    # the loaders' host libraries: the tar index and the JPEG decoder
    host_seconds = _build.build_host()
    regs = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                if "Used" in ln or "spill" in ln or "C75" in ln]
            for n in _build.SOURCES}
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          per_kernel=seconds, per_host_library=host_seconds, ptxas=regs)
    from keystone_tpu_torch.telemetry import compiles_snapshot

    compiles_after_build = compiles_snapshot()

    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha, mv, patch = 0.25, 0.0, 6

    def conv_inputs(n, side, k):
        x = torch.rand((n, side, side, 3), generator=gen, device=dev)
        kern = torch.randn((patch, patch, 3, k), generator=gen,
                           device=dev) / 10.0
        cs = torch.randn((k,), generator=gen, device=dev)
        bs = torch.randn((k,), generator=gen, device=dev)
        return x, kern, kernels.hwio_to_cmajor(kern).contiguous(), cs, bs

    # the first timed geometry is the headline; the 24x24 one is timed
    # under "augmented"
    k1_checks, k1 = [], None
    for n, side, k, normalize, pool, stride, timed in CONV_CHECKS:
        x, kern, g, cs, bs = conv_inputs(n, side, k)
        before = kernels.conv_rectify_pool.launches
        got = kernels.conv_rectify_pool(x, g, cs, bs, alpha, mv, pool,
                                        stride, normalize, patch)
        torch.cuda.synchronize()
        calls = kernels.conv_rectify_pool.launches - before
        want = kernels.conv_rectify_pool_reference(
            x, kern, cs, bs, alpha, mv, pool, stride, normalize)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"conv_rectify_pool: bad output at n={n} side={side} k={k}")
        err, rel = rel_err(got, want)
        check(rel <= K1_TOL, f"conv_rectify_pool n={n} side={side} k={k} "
              f"normalize={normalize}: relative error {rel} > {K1_TOL}")
        k1_checks.append(dict(n=n, side=side, k=k, normalize=normalize,
                              pool=pool, stride=stride, launches=calls,
                              max_abs_err=err, rel_err=rel))
        if timed:
            t = dict(n=n, side=side, k=k, pool=pool, stride=stride,
                     launches=calls, max_abs_err=err, rel_err=rel)
            t["ms"] = time_ms(lambda: kernels.conv_rectify_pool(
                x, g, cs, bs, alpha, mv, pool, stride, normalize, patch))
            t["device_ms"] = device_ms([lambda: kernels.conv_rectify_pool(
                x, g, cs, bs, alpha, mv, pool, stride, normalize, patch)] * 20)
            t["plain_ms"] = time_ms(
                lambda: kernels.conv_rectify_pool_reference(
                    x, kern, cs, bs, alpha, mv, pool, stride, normalize))
            xb = x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
            wb = kern.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            t["conv2d_bf16_conv_only_ms"] = time_ms(lambda: F.conv2d(xb, wb))
            t["bound_ms"], t["bound_by"] = k1_bound_ms(
                n, side, side, 3, patch, k, pool, stride)
            del xb, wb
            if k1 is None:
                k1 = t
            else:
                k1["augmented"] = t
        del x, kern, g, cs, bs, got, want
    check(k1["augmented"]["launches"] == 1, f"conv_rectify_pool at 24x24 "
          f"took {k1['augmented']['launches']} launches for 256 filters")

    k2_checks, k2 = [], None  # the first geometry is the headline
    for n, h, w, k, p, s, a, m in ((HEADLINE_N, 27, 27, 256, 14, 13, 0.25,
                                    0.0),
                                   (37, 27, 27, 100, 14, 13, 0.25, 0.0),
                                   (5, 10, 14, 4, 5, 3, 0.1, 0.05)):
        x = torch.randn((n, h, w, k), generator=gen, device=dev)
        got = kernels.rectify_pool(x, a, m, p, s)
        torch.cuda.synchronize()
        want = kernels.rectify_pool_reference(x, a, m, p, s)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"rectify_pool: bad output at {(n, h, w, k)}")
        err, rel = rel_err(got, want)
        check(rel <= K2_TOL, f"rectify_pool {(n, h, w, k)}: relative error "
              f"{rel} > {K2_TOL}")
        k2_checks.append(dict(shape=[n, h, w, k], max_abs_err=err,
                              rel_err=rel))
        if k2 is None:
            k2 = dict(max_abs_err=err, rel_err=rel)
            k2["ms"] = time_ms(lambda: kernels.rectify_pool(x, a, m, p, s))
            k2["device_ms"] = device_ms(
                [lambda: kernels.rectify_pool(x, a, m, p, s)] * 20)
            k2["plain_ms"] = time_ms(
                lambda: kernels.rectify_pool_reference(x, a, m, p, s))
            gy, gx = kernels.pooled_grid(h, w, p, s)
            k2["bound_ms"], k2["bound_by"] = k2_bound_ms(n, h, w, k, p, gy,
                                                         gx)
        del x, got, want

    def chain_case(chain, d=1024):
        """(statics, params) of a chain: LinearPixels' trail; every
        other head over (d,) rows with the scale form masked; or the
        same without NormalizeRows (``elementwise_heads``)."""
        if chain == "linear_pixels":
            return ((("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",)),
                    [(), (), ()])
        sign = torch.randint(0, 2, (d,), generator=gen, device=dev) * 2.0
        statics = [("LinearRectifier",), ("RandomSignNode",),
                   ("SignedHellingerMapper",), ("NormalizeRows",),
                   (("StandardScaler", "scale"), "masked"),
                   ("StandardScaler", "center")]
        params = [(-0.3, 0.1), (sign - 1.0,), (), (1e-3,),
                  (torch.randn((d,), generator=gen, device=dev),
                   torch.rand((d,), generator=gen, device=dev) + 0.5),
                  (torch.randn((d,), generator=gen, device=dev),)]
        if chain == "elementwise_heads":
            del statics[3], params[3]
        return tuple(statics), params

    k4_checks, k4 = [], None  # the first case is the headline
    for chain, n, item, masked_rows in (
            ("linear_pixels", CHAIN_N, (32, 32, 3), 0),
            ("linear_pixels", 37, (32, 32, 3), 0),
            ("every_other_head", 37, (1024,), 5)):
        statics, params = chain_case(chain)
        if chain == "linear_pixels":
            x = torch.rand((n,) + item, generator=gen, device=dev) * 255.0
        else:
            x = torch.randn((n,) + item, generator=gen, device=dev)
        mask = None
        if masked_rows:
            mask = torch.arange(n, device=dev) < n - masked_rows
        got = chain_kernels.elementwise_chain(statics, params, x, mask)
        torch.cuda.synchronize()
        want = chain_kernels.elementwise_chain_reference(statics, params, x,
                                                         mask)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"elementwise_chain {chain}: bad output at n={n}")
        err, rel = rel_err(got, want)
        check(rel <= K4_TOL, f"elementwise_chain {chain} n={n}: relative "
              f"error {rel} > {K4_TOL}")
        k4_checks.append(dict(chain=chain, n=n, masked_rows=masked_rows,
                              max_abs_err=err, rel_err=rel))
        if k4 is None:
            k4 = dict(max_abs_err=err, rel_err=rel)
            k4["ms"] = time_ms(lambda: chain_kernels.elementwise_chain(
                statics, params, x, mask))
            k4["plain_ms"] = time_ms(
                lambda: chain_kernels.elementwise_chain_reference(
                    statics, params, x, mask))
            k4["bound_ms"], k4["bound_by"] = k4_bound_ms(
                n, chain_kernels.chain_layout(statics, params, item, dev))
            # one PyTorch call computes LinearPixels' chain: the pixels
            # times the gray weights over 255, already one row per image
            w_gray = torch.tensor(GRAY_WEIGHTS, dtype=torch.float32,
                                  device=dev) / 255.0
            lib = torch.matmul(x, w_gray).reshape(n, -1)
            _, lib_rel = rel_err(lib, want)
            check(lib.shape == want.shape and lib_rel <= K4_TOL,
                  f"elementwise_chain library call: relative error "
                  f"{lib_rel} > {K4_TOL}")
            k4["library_rel_err"] = lib_rel
            k4["library_ms"] = time_ms(
                lambda: torch.matmul(x, w_gray).reshape(n, -1))
            # cold: twelve microbatches in turn, as the pipeline feeds them
            xs = [torch.rand((n,) + item, generator=gen, device=dev) * 255.0
                  for _ in range(12)]
            plan = chain_kernels.ChainPlan(statics, params, item, dev)
            outs = [torch.empty((n,) + plan.out_shape, device=dev)
                    for _ in xs]
            planned = [lambda xb=xb, ob=ob: plan(xb, None, ob)
                       for xb, ob in zip(xs, outs)]
            k4["plan"] = dict(grid=plan.grid, **vars(plan.layout.launch))
            k4["library_device_ms"] = device_ms(
                [lambda xb=xb: torch.matmul(xb, w_gray).reshape(n, -1)
                 for xb in xs] * 2)
            k4["device_ms"] = device_ms(planned * 2)

            def planned_path():
                for f in planned:
                    f()

            k4["planned_call_ms"], k4["planned_enqueue_ms"] = host_ms(
                planned_path, len(planned))
            del lib, w_gray, xs, outs, planned, plan
        del x, got, want

    # the chains the optimizer's fusion pass tags in the SIFT-Fisher
    # pipelines, built from their nodes, at one fused microbatch:
    # VOC's PixelScaler >> GrayScaler over its 48x48 synthetic images
    # and over 500x333 real ones (the loaders phase's tar: a row too
    # long for shared memory, cut into 333 segments of 1,500 floats, the
    # mask repeated for each segment), and the Fisher-vector tail over
    # VOC's and ImageNet's encodings
    fisher_tail = (MatrixVectorizer(), SignedHellingerMapper(),
                   NormalizeRows())
    im_config = imagenet_sift_lcs_fv.ImageNetSiftLcsFVConfig()
    k4_paths = {}
    for label, nodes, item in (
            ("voc_gray", (PixelScaler(), GrayScaler()), (48, 48, 3)),
            ("voc_gray_real", (PixelScaler(), GrayScaler()),
             (VOC_REAL_H, VOC_REAL_W, 3)),
            ("voc_fisher", fisher_tail, (VOC_PCA_DIMS, 2 * VOC_GMM_K)),
            ("imagenet_fisher", fisher_tail,
             (im_config.pca_dims, 2 * im_config.gmm_k))):
        fused = [stage_fuse(node) for node in nodes]
        statics, params = tuple(f[0] for f in fused), [f[1] for f in fused]
        n = NodeFusionRule.microbatch
        x = torch.randn((n,) + item, generator=gen, device=dev)
        if label.startswith("voc_gray"):
            x = torch.rand((n,) + item, generator=gen, device=dev) * 255.0
        got = chain_kernels.elementwise_chain(statics, params, x)
        torch.cuda.synchronize()
        want = chain_kernels.elementwise_chain_reference(statics, params, x)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"elementwise_chain {label}: bad output")
        err, rel = rel_err(got, want)
        check(rel <= K4_TOL, f"elementwise_chain {label}: relative error "
              f"{rel} > {K4_TOL}")
        k4_checks.append(dict(chain=label, n=n, masked_rows=0,
                              max_abs_err=err, rel_err=rel))
        # ``ms`` through the public wrapper, which plans each call, as
        # the headline's; ``planned_ms`` and ``device_ms`` through one
        # plan, as the fused transformer calls it
        entry = dict(n=n, item=item, max_abs_err=err, rel_err=rel)
        entry["ms"] = time_ms(lambda: chain_kernels.elementwise_chain(
            statics, params, x))
        plan = chain_kernels.ChainPlan(statics, params, item, dev)
        out = torch.empty_like(got)
        entry["planned_ms"] = time_ms(lambda: plan(x, None, out))
        entry["device_ms"] = device_ms([lambda: plan(x, None, out)] * 4)
        entry["plan"] = dict(grid=plan.grid, **vars(plan.layout.launch))
        entry["plain_ms"] = time_ms(
            lambda: chain_kernels.elementwise_chain_reference(
                statics, params, x))
        entry["bound_ms"], entry["bound_by"] = k4_bound_ms(
            n, chain_kernels.chain_layout(statics, params, item, dev))
        entry["segments"] = plan.segments
        if label == "voc_gray_real":
            check(plan.segments == VOC_REAL_H, f"elementwise_chain {label}:"
                  f" {plan.segments} segments, not {VOC_REAL_H}")
            # the gray stage masked, as a padded chunk's stage is: the
            # last rows zeroed, each row's mask repeated for its segments
            m_statics = statics[:-1] + ((statics[-1], "masked"),)
            mask = torch.arange(n, device=dev) < n - K4_MASKED_ROWS
            plan_m = chain_kernels.ChainPlan(m_statics, params, item, dev)
            got = plan_m(x, mask)
            torch.cuda.synchronize()
            want = chain_kernels.elementwise_chain_reference(
                m_statics, params, x, mask)
            m_err, m_rel = rel_err(got, want)
            zeroed = float(got[n - K4_MASKED_ROWS:].abs().max())
            check(got.shape == want.shape and m_rel <= K4_TOL
                  and zeroed == 0.0, f"elementwise_chain {label} masked: "
                  f"relative error {m_rel} > {K4_TOL} or masked rows "
                  f"{zeroed} != 0")
            k4_checks.append(dict(chain=label, n=n,
                                  masked_rows=K4_MASKED_ROWS,
                                  max_abs_err=m_err, rel_err=m_rel))
            entry["masked"] = dict(masked_rows=K4_MASKED_ROWS,
                                   max_abs_err=m_err, rel_err=m_rel)
            del plan_m, mask
        k4_paths[label] = entry
        del x, got, want, plan, out
    k4["at_path_shapes"] = k4_paths

    # the short-row design (a warp a row, twelve rows a step) against the
    # block-a-row design on the same bytes: 440-float rows (the TIMIT
    # frames of the JAX bench's KRR geometry) through every elementwise
    # head but NormalizeRows, whose sum would change with the grouping,
    # and the same arrays seen as rows of ten frames; cold over four
    # rotating 72 MB inputs, in the order short, grouped, grouped, short
    frames, width, ten = SHORT_ROWS_N, SHORT_ROW_FLOATS, 10
    statics, params = chain_case("elementwise_heads", d=width)
    xs = [torch.randn((frames, width), generator=gen, device=dev)
          for _ in range(4)]
    outs = [torch.empty_like(xb) for xb in xs]
    short_rows = dict(n=frames, row_floats=width, grouped_row_floats=
                      ten * width)
    timed = {}
    for label, shape in (("short", (frames, width)),
                         ("grouped", (frames // ten, ten, width))):
        plan = chain_kernels.ChainPlan(statics, params, shape[1:], dev)
        got = plan(xs[0].view(shape))
        torch.cuda.synchronize()
        err, rel = rel_err(got, chain_kernels.elementwise_chain_reference(
            statics, params, xs[0].view(shape)))
        check(rel <= K4_TOL, f"elementwise_chain {label} rows: relative "
              f"error {rel} > {K4_TOL}")
        short_rows[label] = dict(rows_per_step=plan.layout.launch.rows,
                                 threads_per_row=plan.layout.launch.group,
                                 grid=plan.grid, max_abs_err=err,
                                 rel_err=rel)
        timed[label] = [lambda p=plan, xb=xb, ob=ob, shape=shape: p(
            xb.view(shape), None, ob.view(shape)) for xb, ob in zip(xs, outs)]
        if label == "short":
            short_rows["bound_ms"], short_rows["bound_by"] = k4_bound_ms(
                frames, plan.layout)
    check(short_rows["short"]["threads_per_row"] == 32
          and short_rows["grouped"]["threads_per_row"] == 128,
          f"elementwise_chain short rows: plans {short_rows}")
    order = [device_ms(timed[label] * 2)
             for label in ("short", "grouped", "grouped", "short")]
    short_rows["short"]["device_ms"] = (order[0] + order[3]) / 2
    short_rows["grouped"]["device_ms"] = (order[1] + order[2]) / 2
    short_rows["order_device_ms"] = order
    k4["short_rows"] = short_rows
    del xs, outs, timed, plan, got

    # RBF_TIMED's first geometry is the headline; the augmented one is
    # timed under "augmented"
    k5_checks, k5 = [], None
    for m, n, d, gamma in RBF_GEOMETRIES:
        X = torch.randn((m, d), generator=gen, device=dev)
        # the fit's block: rows of X itself, so the diagonal cancels
        ids = torch.randperm(m, generator=gen, device=dev)[:n]
        Yb = X[ids].contiguous()
        products = kernels.rbf_block.launches
        prepasses = kernels.rbf_split.launches
        got = kernels.rbf_block(X, Yb, gamma)
        torch.cuda.synchronize()
        launched = dict(products=kernels.rbf_block.launches - products,
                        prepasses=kernels.rbf_split.launches - prepasses)
        check(launched == dict(products=1, prepasses=2),
              f"rbf_block {(m, n, d)}: one call counted {launched}")
        want = kernels.rbf_block_reference(X, Yb, gamma)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"rbf_block: bad output at {(m, n, d)}")
        err, rel = rel_err(got, want)
        check(err <= K5_TOL, f"rbf_block {(m, n, d)}: max abs error {err} "
              f"> {K5_TOL}")
        diag = float(got[ids, torch.arange(n, device=dev)].min())
        check(diag >= 1.0 - K5_TOL, f"rbf_block {(m, n, d)}: minimum "
              f"diagonal {diag} < 1 - {K5_TOL}")
        k5_checks.append(dict(m=m, n=n, d=d, gamma=gamma, max_abs_err=err,
                              min_diagonal=diag))
        del got, want
        if (m, n, d) in RBF_TIMED:
            t = dict(m=m, n=n, d=d, gamma=gamma, max_abs_err=err,
                     min_diagonal=diag)
            t["ms"] = time_ms(lambda: kernels.rbf_block(X, Yb, gamma))
            t["device_ms"] = device_ms(
                [lambda: kernels.rbf_block(X, Yb, gamma)] * 10)
            # the prepass alone, on both operands as rbf_block runs it
            t["split_device_ms"] = device_ms(
                [lambda: (kernels.rbf_split(X), kernels.rbf_split(Yb))] * 10)
            t["plain_ms"] = time_ms(
                lambda: kernels.rbf_block_reference(X, Yb, gamma))
            t["matmul_fp32_gemm_only_ms"] = time_ms(lambda: X @ Yb.T)
            # one TF32 product, for this timing only: three of them are
            # what cuBLAS's tensor cores take for the kernel's work
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                t["matmul_tf32_gemm_only_ms"] = time_ms(lambda: X @ Yb.T)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            t["bound_ms"], t["bound_by"] = k5_bound_ms(m, n, d)
            if k5 is None:
                k5 = t
            else:
                k5["augmented"] = t
        del X, Yb
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    phase("kernels", conv_rectify_pool=dict(headline=k1, checks=k1_checks,
                                            tolerance_rel=K1_TOL),
          rectify_pool=dict(headline=k2, checks=k2_checks,
                            tolerance_rel=K2_TOL),
          elementwise_chain=dict(headline=k4, checks=k4_checks,
                                 tolerance_rel=K4_TOL),
          rbf_block=dict(headline=k5, checks=k5_checks,
                         tolerance_abs=K5_TOL))

    # ---- 4. the slice ----------------------------------------------------
    t0 = time.perf_counter()
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device=dev)
    data_seconds = time.perf_counter() - t0
    config = RandomPatchCifarConfig(num_filters=256)
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    # warm pass at the same shapes, as the JAX bench warms its headline
    warm = build_pipeline(train, config)
    evaluator(warm(train.data), train.labels)
    del warm
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    predictor = build_pipeline(train, config)
    train_metrics = evaluator(predictor(train.data), train.labels)
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    test_metrics = evaluator(predictor(test.data), test.labels)
    k1_launches = kernels.conv_rectify_pool.launches
    stages, _ = run_staged(train, config, evaluator)
    microbatches = (math.ceil(train.data.count / config.microbatch)
                    + math.ceil(test.data.count / config.microbatch))
    phase("slice", train_seconds=train_seconds,
          images_per_sec=train.data.count / train_seconds,
          train_error=train_metrics.error,
          test_accuracy=test_metrics.accuracy,
          data_seconds=data_seconds,
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          conv_rectify_pool_launches=k1_launches,
          microbatches=microbatches, stage_seconds=stages, card=card)
    check(test_metrics.accuracy >= 0.72,
          f"test accuracy {test_metrics.accuracy} below 0.72")
    check(k1_launches >= microbatches,
          f"conv_rectify_pool launched {k1_launches} times for "
          f"{microbatches} microbatches")

    # ---- 5. LinearPixels -------------------------------------------------
    lp_config = LinearPixelsConfig()
    warm = build_linear_pixels(train, lp_config)
    evaluator(warm(train.data), train.labels)
    del warm
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    lp = None

    def lp_build():
        nonlocal lp
        lp = build_linear_pixels(train, lp_config)

    lp_steps = [
        ("build", lp_build),
        ("featurize", lambda: cut(lp, 2)(train.data).get()),
        ("normal_equations", lambda: lp.fitted(0)),
        ("predict_eval", lambda: evaluator(lp(train.data), train.labels)),
    ]
    lp_stages, lp_seconds, lp_train = run_stages(lp_steps)
    lp_test = evaluator(lp(test.data), test.labels)
    k4_launches = chain_kernels.elementwise_chain.launches
    lp_peak = torch.cuda.max_memory_allocated()
    # where the workflow layer's host time goes: the same stages again,
    # their executors' optimizer runs and structural checks timed; and
    # the fused apply head (linear map >> argmax) over the 50,000
    # training rows in the fusion pass's 2048-row microbatches against
    # one batch of them all
    PipelineEnv.reset()
    lp_split = host_split(lp_steps)
    pixels = cut(lp, 2)(train.data).get().array
    head_ms = {}
    for rows in (NodeFusionRule.microbatch, train.data.count):
        head = FusedBatchTransformer([lp.fitted(0), MaxClassifier()],
                                     microbatch=rows).batch_fn()
        head_ms[rows] = time_ms(lambda: head(pixels))
    del pixels, head
    lp_split["fused_head_ms_by_microbatch"] = head_ms
    lp_microbatches = (
        math.ceil(train.data.count / LINEAR_PIXELS_MICROBATCH)
        + math.ceil(test.data.count / LINEAR_PIXELS_MICROBATCH))
    phase("linear_pixels", train_seconds=lp_seconds,
          images_per_sec=train.data.count / lp_seconds,
          train_error=lp_train.error, test_accuracy=lp_test.accuracy,
          jax_cpu_test_accuracy=LINEAR_PIXELS_JAX_ACC,
          elementwise_chain_launches=k4_launches,
          microbatches=lp_microbatches, stage_seconds=lp_stages,
          workflow_host_split=lp_split, peak_mem_bytes=lp_peak, card=card)
    check(abs(lp_test.accuracy - LINEAR_PIXELS_JAX_ACC) <= 0.005,
          f"LinearPixels test accuracy {lp_test.accuracy} is not within "
          f"0.005 of {LINEAR_PIXELS_JAX_ACC}")
    check(k4_launches >= lp_microbatches,
          f"elementwise_chain launched {k4_launches} times for "
          f"{lp_microbatches} microbatches")
    del lp
    torch.cuda.empty_cache()

    # ---- 6. RandomPatchCifarKernel ---------------------------------------
    kc_config = RandomPatchCifarKernelConfig(
        num_filters=256, gamma=2e-3, lam=10.0, kernel_block=2048,
        kernel_epochs=1)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    kc = None

    def kc_build():
        nonlocal kc
        kc = build_random_patch_cifar_kernel(train, kc_config)

    # the filters are learned as the pipeline is built; the featurizer
    # fills the Cacher that the scaler's and the solver's fits read
    kc_mark = ledger.session_mark()
    kc_stages, kc_seconds, kc_train = run_stages([
        ("filter_learning", kc_build),
        ("featurize", lambda: cut(kc, 2)(train.data).get()),
        ("scaler", lambda: kc.fitted(0)),
        ("krr_fit", lambda: kc.fitted(1)),
        ("predict_eval", lambda: evaluator(kc(train.data), train.labels)),
    ])
    kc_test_preds = kc(test.data).get()
    kc_test = evaluator(kc_test_preds, test.labels)
    kc_k1 = kernels.conv_rectify_pool.launches
    DATA_AXIS_REF.update(kernel_preds=kc_test_preds.numpy(),
                         kernel_alpha=kc.fitted(1).alpha.cpu().numpy(),
                         kernel_accuracy=kc_test.accuracy,
                         kernel_precision=precision_trails(kc_mark))
    kc_k5 = kernels.rbf_block.launches
    kc_k5_split = kernels.rbf_split.launches
    blocks = math.ceil(train.data.count / kc_config.kernel_block)
    # krr_fit's split: K5's device time at the fit geometry (the kernels
    # phase) times the fit's launches, the last block counted by its rows;
    # the rest is the fit blocks' mask, gather, Cholesky and addmm
    fit_k5_seconds = (k5["device_ms"] / 1e3 * train.data.count
                      / kc_config.kernel_block)
    krr_fit_split = dict(
        k5_seconds=fit_k5_seconds,
        rest_seconds=kc_stages["krr_fit"] - fit_k5_seconds,
        rest_ms_per_block=1e3 * (kc_stages["krr_fit"] - fit_k5_seconds)
        / blocks)
    phase("kernel_cifar", train_seconds=kc_seconds,
          images_per_sec=train.data.count / kc_seconds,
          krr_fit_seconds=kc_stages["krr_fit"], krr_fit_split=krr_fit_split,
          train_error=kc_train.error, test_accuracy=kc_test.accuracy,
          jax_cpu_test_accuracy=KERNEL_CIFAR_JAX_ACC,
          gap_to_jax_cpu=kc_test.accuracy - KERNEL_CIFAR_JAX_ACC,
          conv_rectify_pool_launches=kc_k1, rbf_block_launches=kc_k5,
          rbf_split_launches=kc_k5_split,
          fit_blocks=blocks, stage_seconds=kc_stages,
          peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    check(kc_test.accuracy >= 0.72,
          f"RandomPatchCifarKernel test accuracy {kc_test.accuracy} below "
          f"0.72")
    check(abs(kc_test.accuracy - KERNEL_CIFAR_FP32_ACC) <= 0.005,
          f"RandomPatchCifarKernel test accuracy {kc_test.accuracy} is not "
          f"within 0.005 of {KERNEL_CIFAR_FP32_ACC}")
    check(kc_k5 >= 2 * blocks, f"rbf_block launched {kc_k5} times for "
          f"{blocks} fit blocks and {blocks} apply blocks")
    check(kc_k5_split == 2 * kc_k5, f"rbf_split launched {kc_k5_split} "
          f"times for {kc_k5} products")
    check(kc_k1 >= microbatches, f"conv_rectify_pool launched {kc_k1} "
          f"times for {microbatches} microbatches")
    del kc
    torch.cuda.empty_cache()

    # ---- 7. cross-check: fused kernel vs fp32 conv + rectify_pool --------
    featurizer = predictor.graph.get_operator(predictor.data_path()[0])
    conv = featurizer.stages[1]
    imgs = Dataset(train.data.array[:config.microbatch])
    fused = featurizer.apply_batch(imgs).array
    convolved = conv.apply_batch(PixelScaler().apply_batch(imgs))
    staged_fbt = FusedBatchTransformer(
        [SymmetricRectifier(alpha=config.alpha),
         Pooler(config.pool_stride, config.pool_size, pool_fn="sum"),
         ImageVectorizer()],
        microbatch=config.microbatch)
    check(staged_fbt.planned_kernel is not None
          and staged_fbt.planned_kernel[2] == "rectify_pool_vectorize",
          f"rectify+pool+vectorize planned as {staged_fbt.planned_kernel}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    staged = staged_fbt.apply_batch(convolved).array
    torch.cuda.synchronize()
    k2_launches = kernels.rectify_pool.launches
    k3_launches = kernels.rectify_pool_vectorize.launches
    err, rel = rel_err(fused, staged)
    k3_err, k3_rel = rel_err(staged, kernels.rectify_pool_vectorize_reference(
        convolved.array, config.alpha, 0.0, config.pool_size,
        config.pool_stride))
    phase("cross", max_abs_err=err, rel_err=rel, tolerance_rel=K1_TOL,
          rectify_pool_launches=k2_launches,
          rectify_pool_vectorize_launches=k3_launches,
          rectify_pool_vectorize_max_abs_err=k3_err,
          rectify_pool_vectorize_rel_err=k3_rel,
          rectify_pool_vectorize_tolerance_rel=K2_TOL)
    check(k3_launches >= 1, "the rectify+pool+vectorize stage did not "
          "launch its kernel through rectify_pool_vectorize")
    check(k3_rel <= K2_TOL, f"rectify_pool_vectorize: relative error "
          f"{k3_rel} > {K2_TOL}")
    check(rel <= K1_TOL, f"fused vs staged featurizer: relative error {rel}")

    # ---- 8. run_fused -----------------------------------------------------
    rpc_evaluator = MulticlassClassifierEvaluator(config.num_classes)
    run_fused(train, test, config)  # warm, at the same shapes
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused_res = run_fused(train, test, config)
    fused_seconds = time.perf_counter() - t0
    fused_k1 = kernels.conv_rectify_pool.launches
    fused_peak = torch.cuda.max_memory_allocated()
    fused_syncs, fused_sync_count = count_syncs(
        lambda: run_fused(train, test, config))

    def staged_run():
        p = build_pipeline(train, config)
        rpc_evaluator(p(train.data), train.labels)
        rpc_evaluator(p(test.data), test.labels)

    staged_syncs, staged_sync_count = count_syncs(staged_run)
    fused_acc = fused_res["test_accuracy"]
    phase("fused", train_seconds=fused_seconds,
          images_per_sec=(train.data.count + test.data.count) / fused_seconds,
          rate_basis="train+test images",
          test_accuracy=fused_acc, train_error=fused_res["train_error"],
          slice_test_accuracy=test_metrics.accuracy,
          stage_ms_on_stream=fused_res["stage_ms"],
          staged_stage_seconds=stages, staged_train_seconds=train_seconds,
          conv_rectify_pool_launches=fused_k1, microbatches=microbatches,
          syncs=fused_sync_count, sync_lines=fused_syncs,
          staged_syncs=staged_sync_count, staged_sync_lines=staged_syncs,
          peak_mem_bytes=fused_peak, card=card)
    check(fused_acc >= 0.72, f"run_fused test accuracy {fused_acc} below "
          f"0.72")
    check(abs(fused_acc - test_metrics.accuracy) <= 0.005,
          f"run_fused test accuracy {fused_acc} is not within 0.005 of the "
          f"staged pipeline's {test_metrics.accuracy}")
    check(fused_k1 == microbatches, f"run_fused launched conv_rectify_pool "
          f"{fused_k1} times for {microbatches} microbatches")
    del fused_res
    torch.cuda.empty_cache()

    # ---- 9. RandomCifar --------------------------------------------------
    rc_config = RandomCifarConfig(num_filters=256)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rc = None

    def rc_build():
        nonlocal rc
        rc = build_random_cifar(train, rc_config)

    rc_stages, rc_seconds, rc_train = run_stages([
        ("build", rc_build),
        ("featurize", lambda: cut(rc, 2)(train.data).get()),
        ("scaler", lambda: rc.fitted(0)),
        ("bcd_solve", lambda: rc.fitted(1)),
        ("predict_eval", lambda: evaluator(rc(train.data), train.labels)),
    ])
    rc_test = evaluator(rc(test.data), test.labels)
    rc_k1 = kernels.conv_rectify_pool.launches
    phase("random_cifar", train_seconds=rc_seconds,
          images_per_sec=train.data.count / rc_seconds,
          train_error=rc_train.error, test_accuracy=rc_test.accuracy,
          jax_cpu_test_accuracy=RANDOM_CIFAR_JAX_ACC,
          gap_to_jax_cpu=rc_test.accuracy - RANDOM_CIFAR_JAX_ACC,
          conv_rectify_pool_launches=rc_k1, microbatches=microbatches,
          stage_seconds=rc_stages,
          peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    check(rc_test.accuracy >= 0.72, f"RandomCifar test accuracy "
          f"{rc_test.accuracy} below 0.72")
    check(abs(rc_test.accuracy - RANDOM_CIFAR_JAX_ACC) <= 0.005,
          f"RandomCifar test accuracy {rc_test.accuracy} is not within 0.005 "
          f"of {RANDOM_CIFAR_JAX_ACC}")
    check(rc_k1 == microbatches, f"RandomCifar launched conv_rectify_pool "
          f"{rc_k1} times for {microbatches} microbatches")
    del rc
    torch.cuda.empty_cache()

    # ---- 10. RandomPatchCifarAugmented ------------------------------------
    ag_config = RandomPatchCifarAugmentedConfig(num_filters=256)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ag = ag_scorer = None

    def ag_augment():
        nonlocal ag
        ag = random_crops(train, ag_config)

    def ag_build():
        nonlocal ag_scorer
        ag_scorer = build_random_patch_cifar_augmented(ag, ag_config)

    ag_mark = ledger.session_mark()
    ag_stages, ag_seconds, ag_train = run_stages([
        ("augment", ag_augment),
        ("filter_learning", ag_build),
        ("featurize", lambda: cut(ag_scorer, 2)(ag.data).get()),
        ("scaler", lambda: ag_scorer.fitted(0)),
        ("bcd_solve", lambda: ag_scorer.fitted(1)),
        ("predict_eval", lambda: evaluator(
            (ag_scorer >> MaxClassifier())(ag.data), ag.labels)),
    ])
    test_stages, _, ag_test = run_stages([
        ("test_apply_eval", lambda: score_center_corner_views(
            ag_scorer, test, ag_config, with_flips=False))])
    ag_stages.update(test_stages)
    ag_k1 = kernels.conv_rectify_pool.launches
    DATA_AXIS_REF.update(augmented_accuracy=ag_test.accuracy,
                         augmented_confusion=np.asarray(ag_test.confusion),
                         augmented_W=ag_scorer.fitted(1).W.cpu().numpy(),
                         augmented_precision=precision_trails(ag_mark))
    ag_microbatches = (math.ceil(ag.data.count / ag_config.microbatch)
                       + math.ceil(5 * test.data.count / ag_config.microbatch))
    phase("augmented", train_seconds=ag_seconds,
          train_views=ag.data.count,
          views_per_sec=ag.data.count / ag_seconds,
          train_error=ag_train.error, test_accuracy=ag_test.accuracy,
          test_views=5 * test.data.count,
          jax_cpu_test_accuracy=AUGMENTED_JAX_ACC,
          gap_to_jax_cpu=ag_test.accuracy - AUGMENTED_JAX_ACC,
          conv_rectify_pool_launches=ag_k1, microbatches=ag_microbatches,
          stage_seconds=ag_stages,
          peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    check(ag.data.count == N_AUG_TRAIN, f"{ag.data.count} training crops")
    check(ag_test.accuracy >= 0.72, f"RandomPatchCifarAugmented test "
          f"accuracy {ag_test.accuracy} below 0.72")
    check(abs(ag_test.accuracy - AUGMENTED_JAX_ACC) <= 0.01,
          f"RandomPatchCifarAugmented test accuracy {ag_test.accuracy} is "
          f"not within 0.01 of {AUGMENTED_JAX_ACC}")
    check(ag_k1 == ag_microbatches, f"RandomPatchCifarAugmented launched "
          f"conv_rectify_pool {ag_k1} times for {ag_microbatches} "
          f"microbatches")
    del ag, ag_scorer
    torch.cuda.empty_cache()

    # ---- 11. RandomPatchCifarAugmentedKernel -------------------------------
    ak_config = RandomPatchCifarAugmentedKernelConfig(
        num_filters=256, gamma=2e-4, lam=10.0, kernel_block=2048,
        kernel_epochs=1)
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ak = ak_scorer = None

    def ak_augment():
        nonlocal ak
        ak = flipped_shuffled_crops(train, ak_config)

    def ak_build():
        nonlocal ak_scorer
        ak_scorer = build_random_patch_cifar_augmented_kernel(ak, ak_config)

    ak_mark = ledger.session_mark()
    ak_stages, ak_seconds, ak_train = run_stages([
        ("augment", ak_augment),
        ("filter_learning", ak_build),
        ("featurize", lambda: cut(ak_scorer, 2)(ak.data).get()),
        ("scaler", lambda: ak_scorer.fitted(0)),
        ("krr_fit", lambda: ak_scorer.fitted(1)),
        ("predict_eval", lambda: evaluator(
            (ak_scorer >> MaxClassifier())(ak.data), ak.labels)),
    ])
    ak_fit_products = kernels.rbf_block.launches
    test_stages, _, ak_test = run_stages([
        ("test_apply_eval", lambda: score_center_corner_views(
            ak_scorer, test, ak_config, with_flips=True))])
    ak_stages.update(test_stages)
    ak_k1 = kernels.conv_rectify_pool.launches
    DATA_AXIS_REF.update(
        augmented_kernel_accuracy=ak_test.accuracy,
        augmented_kernel_confusion=np.asarray(ak_test.confusion),
        augmented_kernel_alpha=ak_scorer.fitted(1).alpha.cpu().numpy(),
        augmented_kernel_precision=precision_trails(ak_mark))
    ak_k5 = kernels.rbf_block.launches
    ak_k5_split = kernels.rbf_split.launches
    ak_blocks = math.ceil(ak.data.count / ak_config.kernel_block)
    ak_apply_blocks = math.ceil(ak.data.count / ak_config.kernel_block)
    ak_microbatches = (
        math.ceil(ak.data.count / ak_config.microbatch)
        + math.ceil(10 * test.data.count / ak_config.microbatch))
    ak_fit_k5_seconds = (k5["augmented"]["device_ms"] / 1e3 * ak.data.count
                         / ak_config.kernel_block)
    ak_split = dict(
        k5_seconds=ak_fit_k5_seconds,
        rest_seconds=ak_stages["krr_fit"] - ak_fit_k5_seconds,
        rest_ms_per_block=1e3 * (ak_stages["krr_fit"] - ak_fit_k5_seconds)
        / ak_blocks)
    phase("augmented_kernel", train_seconds=ak_seconds,
          train_views=ak.data.count,
          views_per_sec=ak.data.count / ak_seconds,
          krr_fit_seconds=ak_stages["krr_fit"], krr_fit_split=ak_split,
          train_error=ak_train.error, test_accuracy=ak_test.accuracy,
          test_views=10 * test.data.count,
          conv_rectify_pool_launches=ak_k1, microbatches=ak_microbatches,
          rbf_block_launches=ak_k5, rbf_split_launches=ak_k5_split,
          rbf_block_launches_through_train_eval=ak_fit_products,
          fit_blocks=ak_blocks, test_apply_blocks=ak_apply_blocks,
          stage_seconds=ak_stages,
          peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    check(ak.data.count == N_AUG_TRAIN, f"{ak.data.count} training crops")
    check(ak_test.accuracy >= 0.72, f"RandomPatchCifarAugmentedKernel test "
          f"accuracy {ak_test.accuracy} below 0.72")
    check(ak_k5 >= ak_blocks + ak_apply_blocks, f"rbf_block launched "
          f"{ak_k5} times for {ak_blocks} fit blocks and {ak_apply_blocks} "
          f"test-apply blocks")
    check(ak_k5_split == 2 * ak_k5, f"rbf_split launched {ak_k5_split} "
          f"times for {ak_k5} products")
    check(ak_k1 == ak_microbatches, f"RandomPatchCifarAugmentedKernel "
          f"launched conv_rectify_pool {ak_k1} times for {ak_microbatches} "
          f"microbatches")
    del ak, ak_scorer
    torch.cuda.empty_cache()

    # ---- 12. TIMIT ---------------------------------------------------------
    tm_config = timit.TimitConfig(n_synth=TIMIT_N_SYNTH)
    t0 = time.perf_counter()
    tm_train, tm_test, tm_classes = timit.load(tm_config, dev)
    tm_data_seconds = time.perf_counter() - t0
    timit.run_on(tm_train, tm_test, tm_config, tm_classes)  # warm
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    tm = timit.run_on(tm_train, tm_test, tm_config, tm_classes)
    tm_peak = torch.cuda.max_memory_allocated()
    tm_launches = launch_counts()
    del tm["predictor"]
    # the same run one stage at a time, each closed by a device sync
    tm_dim = tm_train.data.array.shape[1]
    tm_stages = {}
    tm_stages["featurize"], tm_X = timed_s(
        lambda: timit.featurizer(tm_dim, tm_config, dev)(tm_train.data)
        .get().array)
    tm_Y = ClassLabelIndicatorsFromInt(tm_classes)(tm_train.labels).get().array
    marks = []

    def mark(epoch):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    tm_W, tm_b, tm_info = bcd_fit(tm_X, tm_Y, tm_config.lam,
                                  tm_config.block_size, tm_config.num_epochs,
                                  on_epoch=mark)
    raise_if_unfactored(tm_info)
    tm_stages["bcd_epochs"] = [b - a for a, b in zip([t0] + marks, marks)]
    tm_eval = MulticlassClassifierEvaluator(tm_classes)
    tm_stages["predict_eval"], _ = timed_s(lambda: tm_eval(
        (BlockLinearMapper(tm_W, tm_b) >> MaxClassifier())(tm_train.data
                                                           .with_data(tm_X)),
        tm_train.labels))
    phase("timit", train_seconds=tm["train_seconds"],
          frames_per_sec=tm["frames_per_sec"],
          train_error=tm["train_error"], test_accuracy=tm["test_accuracy"],
          jax_cpu_test_accuracy=TIMIT_JAX_ACC,
          gap_to_jax_cpu=tm["test_accuracy"] - TIMIT_JAX_ACC,
          train_frames=tm_train.data.count, test_frames=tm_test.data.count,
          classes=tm_classes, staged_stage_seconds=tm_stages,
          data_seconds=tm_data_seconds, peak_mem_bytes=tm_peak,
          launches=tm_launches, card=card)
    check(abs(tm["test_accuracy"] - TIMIT_JAX_ACC) <= 0.005,
          f"TIMIT test accuracy {tm['test_accuracy']} is not within 0.005 "
          f"of {TIMIT_JAX_ACC}")
    del tm_test, tm_W, tm_b
    torch.cuda.empty_cache()

    # ---- 13. MnistRandomFFT ------------------------------------------------
    mn_config = mnist_random_fft.MnistRandomFFTConfig()
    t0 = time.perf_counter()
    mn_train = timit.synthetic_timit(MNIST_N_TRAIN, MNIST_DIM, MNIST_CLASSES,
                                     mn_config.seed, device=dev)
    mn_test = timit.synthetic_timit(MNIST_N_TEST, MNIST_DIM, MNIST_CLASSES,
                                    mn_config.seed + 1, device=dev)
    mn_data_seconds = time.perf_counter() - t0
    # a label-first CSV of the first rows, read back through the loader
    rows_y = mn_train.labels.take(MNIST_CSV_ROWS)
    rows_x = mn_train.data.take(MNIST_CSV_ROWS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mnist.csv")
        np.savetxt(path, np.column_stack([rows_y, rows_x]), delimiter=",",
                   fmt="%.9g")
        back = LabeledData.label_featured_csv(path, device=dev)
    csv_equal = (np.array_equal(back.labels.numpy(), rows_y)
                 and np.array_equal(back.data.numpy(), rows_x))
    del back
    mnist_random_fft.run_on(mn_train, mn_test, mn_config)  # warm
    torch.cuda.synchronize()
    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mn = mnist_random_fft.run_on(mn_train, mn_test, mn_config)
    mn_launches = launch_counts()
    # the test apply's plan: the gather pass's fused stage, no chain kernel
    mn_gathers = fused_in_plan(mn.pop("predictor")(mn_test.data))
    mn_planned = [f.planned_kernel for f in mn_gathers]
    # what the workflow runtime's knobs cost this run: each run
    # builds its pipeline anew, as a one-shot run does
    mn_knobs = {knob: [] for knob in ("default", "megafusion_off",
                                      "all_off")}
    knob_fields = dict(default={}, megafusion_off=dict(megafusion=False),
                       all_off=dict(megafusion=False, overlap=False,
                                    aot_warmup=False,
                                    concurrent_dispatch=False))
    for knob in ("default", "megafusion_off", "all_off", "all_off",
                 "megafusion_off", "default"):
        PipelineEnv.reset()
        with config_override(**knob_fields[knob]):
            mn_knobs[knob].append(mnist_random_fft.run_on(
                mn_train, mn_test, mn_config)["seconds"])
        drain_warmups()
    phase("mnist", seconds=mn["seconds"], rows_per_sec=mn["rows_per_sec"],
          seconds_by_knob=mn_knobs,
          rate_basis="train+test rows", train_error=mn["train_error"],
          test_accuracy=mn["test_accuracy"],
          jax_cpu_test_accuracy=MNIST_JAX_ACC,
          gap_to_jax_cpu=mn["test_accuracy"] - MNIST_JAX_ACC,
          features=mn_config.num_ffts * 512,
          fused_transformers=[f.label for f in mn_gathers],
          planned_kernels=mn_planned,
          csv_rows=MNIST_CSV_ROWS, csv_round_trip_equal=csv_equal,
          data_seconds=mn_data_seconds,
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          launches=mn_launches, card=card)
    check(csv_equal, "the label-first CSV did not read back equal")
    check(abs(mn["test_accuracy"] - MNIST_JAX_ACC) <= 0.005,
          f"MnistRandomFFT test accuracy {mn['test_accuracy']} is not within "
          f"0.005 of {MNIST_JAX_ACC}")
    check(any(isinstance(f.stages[0], _GatherConcatStage)
              for f in mn_gathers),
          "MnistRandomFFT's gather was not fused into one stage")
    check(not any(mn_planned), f"MnistRandomFFT planned {mn_planned}")
    check(not any(mn_launches.values()),
          f"MnistRandomFFT launched kernels: {mn_launches}")
    del mn_train, mn_test, mn_gathers
    torch.cuda.empty_cache()

    # ---- 14. solvers on the TIMIT features ---------------------------------
    sv_lam = tm_config.lam
    sv_n = tm_X.shape[0]
    sv_labels = tm_train.labels.array.long()
    sv_data, sv_y = tm_train.data.with_data(tm_X), tm_train.data.with_data(
        tm_Y)

    def objective(W, b):
        """½‖XW + b − Y‖² + ½λ‖W‖², the products in fp32, the sums in
        float64."""
        r = torch.addmm(b, tm_X, W) - tm_Y
        return float(0.5 * r.double().square().sum()
                     + 0.5 * sv_lam * W.double().square().sum())

    def train_acc(W, b):
        return float((torch.addmm(b, tm_X, W).argmax(1) == sv_labels)
                     .double().mean())

    def exact():
        return normal_equations(tm_X, tm_Y, sv_n, sv_lam, True)

    def bcd():
        W, b, info = bcd_fit(tm_X, tm_Y, sv_lam, tm_config.block_size,
                             tm_config.num_epochs)
        raise_if_unfactored(info)
        return W, b

    lbfgs = DenseLBFGSwithL2(lam=sv_lam, num_iters=20, memory_size=10)

    def lbfgs_fit():
        model = lbfgs.fit(sv_data, sv_y)
        return model.W, model.b

    solvers = {}
    for label, fit in (("exact", exact), ("bcd", bcd), ("lbfgs", lbfgs_fit)):
        fit()  # warm
        seconds, (W, b) = timed_s(fit)
        solvers[label] = dict(seconds=seconds, objective=objective(W, b),
                              train_accuracy=train_acc(W, b))
        del W, b
    for label in ("bcd", "lbfgs"):
        solvers[label]["objective_over_exact"] = (
            solvers[label]["objective"] / solvers["exact"]["objective"] - 1.0)
    solvers["bcd"].update(jax_cpu_objective=BCD_JAX_OBJECTIVE,
                          objective_over_jax_cpu=(solvers["bcd"]["objective"]
                                                  / BCD_JAX_OBJECTIVE - 1.0))
    history = lbfgs.loss_history.tolist()
    lbfgs_syncs, lbfgs_sync_count = count_syncs(lbfgs_fit)
    solvers["lbfgs"].update(
        loss_history=history, linesearch_steps=lbfgs.linesearch_steps,
        evaluations=sum(lbfgs.linesearch_steps), syncs=lbfgs_sync_count,
        sync_lines=lbfgs_syncs, jax_cpu_objective=LBFGS_JAX_OBJECTIVE,
        objective_over_jax_cpu=(solvers["lbfgs"]["objective"]
                                / LBFGS_JAX_OBJECTIVE - 1.0))
    # the dual form where d > n: the first 2048 rows, against the primal
    # ridge without intercept in float64 on the same rows
    Xd, Yd = tm_X[:2048], tm_Y[:2048]
    dual = LocalLeastSquaresEstimator(sv_lam)
    dual.fit(tm_train.data.with_data(Xd, count=2048),
             tm_train.data.with_data(Yd, count=2048))  # warm
    dual_seconds, dual_model = timed_s(lambda: dual.fit(
        tm_train.data.with_data(Xd, count=2048),
        tm_train.data.with_data(Yd, count=2048)))
    X64 = Xd.double()
    primal = torch.linalg.solve(
        X64.T @ X64 + sv_lam * torch.eye(X64.shape[1], dtype=torch.float64,
                                         device=dev), X64.T @ Yd.double())
    dual_rel = float((dual_model.W.double() - primal).abs().max()
                     / primal.abs().max())
    solvers["local_least_squares"] = dict(
        rows=2048, features=Xd.shape[1], seconds=dual_seconds,
        rel_diff_from_primal=dual_rel, primal="float64 normal equations")
    phase("solvers", n=sv_n, d=tm_X.shape[1], k=tm_Y.shape[1], lam=sv_lam,
          solvers=solvers, card=card)
    check(all(b - a <= LBFGS_APPROX_DECREASE * abs(a)
              for a, b in zip(history, history[1:])),
          f"L-BFGS loss history increases: {history}")
    check(abs(solvers["lbfgs"]["objective_over_jax_cpu"])
          <= LBFGS_OBJECTIVE_RTOL,
          f"L-BFGS objective {solvers['lbfgs']['objective']} is not within "
          f"{LBFGS_OBJECTIVE_RTOL} of JAX's {LBFGS_JAX_OBJECTIVE}")
    check(abs(solvers["bcd"]["objective"] / BCD_JAX_OBJECTIVE - 1.0)
          <= BCD_OBJECTIVE_RTOL,
          f"BCD objective {solvers['bcd']['objective']} is not within "
          f"{BCD_OBJECTIVE_RTOL} of JAX's {BCD_JAX_OBJECTIVE}")
    check(min(solvers["bcd"]["objective_over_exact"],
              solvers["lbfgs"]["objective_over_exact"]) >= -1e-6,
          "an iterative solver's objective is below the exact minimum")
    check(dual_rel <= DUAL_PRIMAL_RTOL, f"dual solve differs from the primal "
          f"by {dual_rel}")
    del tm_X, tm_Y, sv_data, sv_y, dual_model, primal, X64, tm_train
    torch.cuda.empty_cache()

    # ---- 15-16. VOCSIFTFisher and ImageNetSiftLcsFV ------------------------
    voc_k4 = voc_phase(dev, card)
    torch.cuda.empty_cache()
    imagenet_k4 = imagenet_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- 17-19. the text family -------------------------------------------
    newsgroups_phase(dev, card)
    torch.cuda.empty_cache()
    amazon = amazon_phase(dev, card)
    torch.cuda.empty_cache()
    stupid_backoff_phase(dev, card)

    # ---- 20. the workflow: fit, save, load, apply ---------------------------
    workflow_k4 = workflow_phase(train, test, config, sum(stages.values()),
                                 test_metrics.accuracy, card)
    torch.cuda.empty_cache()

    # ---- 21-22. the solver choice; HOG and DAISY ---------------------------
    least_squares_phase(dev, card, amazon)
    text_axis_sparse_reference(amazon)
    del amazon
    torch.cuda.empty_cache()
    hog_daisy_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- 23. the workflow runtime ------------------------------------------
    runtime = runtime_phase(dev, train, test, config, card)
    torch.cuda.empty_cache()

    # ---- 24-25. the image loaders; telemetry ----------------------------------
    loaders = loaders_phase(dev, card)
    torch.cuda.empty_cache()
    telemetry_k1 = telemetry_phase(dev, train, test, config, card,
                                   compiles_after_build, runtime)
    torch.cuda.empty_cache()

    # ---- 26. serving ----------------------------------------------------------
    serving = serving_phase(dev, train, test, config, card)
    torch.cuda.empty_cache()

    # ---- 27-28. the planners; out of core -------------------------------------
    planners = planners_phase(dev, train, test, config, lp_config, card)
    torch.cuda.empty_cache()
    ooc = out_of_core_phase(dev, config, card)
    torch.cuda.empty_cache()

    # ---- 29. the measurement tier ------------------------------------------
    measurement = measurement_phase(dev, train, test, config, lp_config, card)
    torch.cuda.empty_cache()

    # ---- 30. the POS and NER taggers -----------------------------------------
    nlp_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- 31. the data axis: an NCCL group of one rank ------------------------
    par = parallel_phase(dev, train, test, config, card)
    torch.cuda.empty_cache()

    # ---- 32. the model axis: the static tier; two ranks on the card ----------
    model_axis = model_axis_phase(dev, card, par)
    torch.cuda.empty_cache()

    # ---- 33. the data axis for the image estimators: two ranks on the card
    data_axis = data_axis_phase(card)
    torch.cuda.empty_cache()

    # ---- 34. the text side of the data axis: two ranks on the card ---------
    text_axis = text_axis_phase(card)
    torch.cuda.empty_cache()

    record = {"kernels": [
        dict(name="conv_rectify_pool", route="cuda",
             source="keystone_tpu_torch/csrc/conv_rectify_pool.cu",
             replaces="keystone_tpu/ops/pallas_kernels.py:591",
             launches=k1_launches, max_abs_err=k1["max_abs_err"],
             rel_err=k1["rel_err"], tolerance_rel=K1_TOL, ms=k1["ms"],
             device_ms=k1["device_ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             conv2d_bf16_conv_only_ms=k1["conv2d_bf16_conv_only_ms"],
             augmented=dict(k1["augmented"], library_ms=None),
             launches_by_path=dict(
                 slice=k1_launches, kernel_cifar=kc_k1, fused=fused_k1,
                 runtime=runtime["k1"], telemetry=telemetry_k1,
                 serving=serving["k1"],
                 random_cifar=rc_k1, augmented=ag_k1,
                 augmented_kernel=ak_k1,
                 planners=planners["random_patch_cifar"]["k1"],
                 out_of_core=ooc["k1"], measurement=measurement["k1"],
                 parallel=par["k1"], model_axis=model_axis["k1"],
                 data_axis={name: [r["conv_rectify_pool"] for r in ranks]
                            for name, ranks in data_axis.items()}),
             parallel_check=par["k1_check"],
             model_axis_check=model_axis["k1_check"],
             ptxas=regs["conv_rectify_pool"]),
        dict(name="rectify_pool", route="cuda",
             source="keystone_tpu_torch/csrc/rectify_pool.cu",
             replaces="keystone_tpu/ops/pallas_kernels.py:132",
             also_replaces="keystone_tpu/ops/chain_kernels.py:346",
             launches=k2_launches,
             rectify_pool_vectorize_launches=k3_launches,
             max_abs_err=k2["max_abs_err"],
             rel_err=k2["rel_err"], tolerance_rel=K2_TOL, ms=k2["ms"],
             device_ms=k2["device_ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="elementwise_chain", route="cuda",
             source="keystone_tpu_torch/csrc/elementwise_chain.cu",
             replaces="keystone_tpu/ops/chain_kernels.py:504",
             launches=k4_launches,
             launches_by_path=dict(linear_pixels=k4_launches, voc=voc_k4,
                                   imagenet=imagenet_k4,
                                   workflow=workflow_k4,
                                   runtime=runtime["k4"],
                                   voc_tar=loaders["voc_big_k4"],
                                   serving=serving["k4"],
                                   planners=planners["linear_pixels"]["k4"],
                                   measurement=measurement["k4"],
                                   data_axis={
                                       name: [r["elementwise_chain"]
                                              for r in data_axis[name]]
                                       for name in ("voc", "imagenet",
                                                    "side_voc")}),
             max_abs_err=k4["max_abs_err"],
             rel_err=k4["rel_err"], tolerance_rel=K4_TOL, ms=k4["ms"],
             device_ms=k4["device_ms"],
             planned_call_ms=k4["planned_call_ms"],
             planned_enqueue_ms=k4["planned_enqueue_ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=k4["library_ms"],
             library_device_ms=k4["library_device_ms"],
             library_call="torch.matmul(x, gray_weights / 255)",
             library_rel_err=k4["library_rel_err"], plan=k4["plan"],
             short_rows=k4["short_rows"],
             at_path_shapes=k4["at_path_shapes"]),
        dict(name="rbf_block", route="cuda",
             source="keystone_tpu_torch/csrc/rbf_block.cu",
             replaces="keystone_tpu/ops/pallas_kernels.py:212",
             launches=kc_k5, split_launches=kc_k5_split,
             launches_by_path=dict(
                 kernel_cifar=dict(products=kc_k5, prepasses=kc_k5_split),
                 augmented_kernel=dict(products=ak_k5,
                                       prepasses=ak_k5_split),
                 data_axis={name: [dict(products=r["rbf_block"],
                                        prepasses=r["rbf_split"])
                                   for r in data_axis[name]]
                            for name in ("kernel", "augmented_kernel",
                                         "whole_kernel",
                                         "whole_augmented_kernel")},
                 text_axis=text_axis),
             augmented=dict(k5["augmented"], library_ms=None),
             max_abs_err=k5["max_abs_err"],
             min_diagonal=k5["min_diagonal"], tolerance_abs=K5_TOL,
             ms=k5["ms"], device_ms=k5["device_ms"],
             split_device_ms=k5["split_device_ms"], plain_ms=k5["plain_ms"],
             bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
             library_ms=None,
             matmul_fp32_gemm_only_ms=k5["matmul_fp32_gemm_only_ms"],
             matmul_tf32_gemm_only_ms=k5["matmul_tf32_gemm_only_ms"],
             ptxas=regs["rbf_block"]),
    ]}
    phase("total", seconds=time.perf_counter() - script_t0, card=card)
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
