#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py     # a few minutes, builds the kernels itself

Phases, each of which fails the run (non-zero exit, no result line):

1. setup: the card's name and power limit, versions, and an ``nvcc`` build
   of every kernel in ``gridnext_tpu_torch/csrc/`` (all started together);
   the FAVOR library's SASS must hold tensor-core (HMMA) instructions and
   the dense-block library's warpgroup (HGMMA) ones; ptxas's register and
   spill report of the dense-layer kernel is logged;
2. the patch-gather kernel on 4 random 9,325 x 8,892 x 3 uint8 slides with
   4 x 4,992 lattice spots (+ edge-clamped, parked and out-of-range-slide
   spots), bit-exact against its plain version, timed against its bound and
   against the crop as one PyTorch call (``aten::index`` on an unfold view,
   the library time); also windows 24 and 97 (the byte path) and 128 and
   160 (the bulk-copy path) at every source offset mod 16, bit-exact;
3. the hex-corrector kernel on 4 random 78 x 64 x 7 grids, logits within
   1e-4 and labels equal (up to near-tie flips) against the plain version,
   one launch a wrapper call; the same at 33 classes and at c_in 1024 with
   64 classes; each wrapper is timed three ways: CUDA events around
   back-to-back wrapper calls, the host's time to issue one call, and the
   device time of its kernel alone from a torch.profiler trace;
4. the main path at full width, as a model directory serves: positions
   files read by ``io.read_positions``, ``modeldir.image_registrar_from_meta``
   for the default ``TpuPatchClassifier`` (stages (256,2),(512,2), stem 16,
   RMSNorm, f32) and the BatchNorm hex corrector, with random weights from a
   numpy seed in the JAX checkpoint layout (through the weight bridge);
   ``__call__``, ``register_logits`` and ``register_batch`` over the 4
   slides, and ``evaluate.to_loupe_annots``. Both kernels must have
   launched, the foreground must equal each tissue mask, the Loupe CSV must
   name each spot's class, the labels must equal the plain-version
   registrar's up to near-ties, and ``register_logits`` must match a direct
   GridNetHex forward on the same patch grid; then the time of
   ``register_batch`` (kernels and plain in turns) and a torch.profiler
   table of one call, with the ported kernels' device time in it;
5. the dense-block kernel at DenseNet-121's four block shapes with B = 624
   (128-px patches), folded from random weights (numpy seed): within
   rtol = atol = 3e-2 of its plain version with a correlation above 0.999,
   each block timed as phases 2-3 time theirs, beside its bound, its
   layer-at-a-time floor (the larger of the FLOP time and the bytes of
   reading each layer's ``c_in`` channels and writing its ``growth``) and,
   as a yardstick the port never calls, the same block as eager bf16 cuDNN
   convolutions in channels-last; then a growth-12 block (widths padded to
   multiples of 8) and a growth-48, Cb-192 block (the general route), each
   against its plain version with its launches counted;
6. DenseNet-121 at full width on the same 4 slides and positions files: the
   model-directory route (``image_registrar_from_meta``, f32 module, TF32
   off) with ``__call__``, ``register_logits`` and ``register_batch``, held
   against the masks and a direct ``GridNetHex(DenseNet)`` forward; the
   fused route (``SlideRegistrar`` on ``build_densenet_fused_infer``, the
   dense-block kernel, the same folded corrector) with ``register_batch``,
   its counts set to 0 just before and read just after (one dense-block
   launch per layer of every block call), its labels equal
   to the f32 route's up to near-ties within the bf16 budget; the fused
   f's logits against the f32 module's on one 624-patch chunk; both
   routes' ``register_batch`` timed in turns, and a torch.profiler table of
   one fused call;
7. the window resize on slide 0 through a ``window_px = 160``,
   ``patch_px = 128`` DenseNet-121 model directory: ``__call__`` and
   ``register_logits`` with the gather and corrector counts set to 0 just
   before and read just after; the gather at 160 px bit-exact against its
   plain version on the registrar's corners; the resize on the card within
   1 of a float64 product; logits within 1e-3 of, and labels equal (up to
   near-ties) to, the plain-version registrar on the same f;
8. the FAVOR kernel at scBERT's shape (B 8, H 10, N 16,907, d 64, m 266),
   at a ragged N with m = 37 and at head widths 48 and 128, inputs from a
   numpy seed and an
   orthogonal Gaussian projection, within rtol 2e-4 / atol 2e-5 of its plain
   version; timed at scBERT's shape as phases 2-3 time theirs, beside its
   split-TF32 bound (three TF32 tensor-core products per f32 product), the
   f32-FMA bound and the bytes bound;
9. one multimodal request at full width: a ``GridNetHexMM`` model
   directory (scBERT over the 16,906 gene2vec genes at its checkpoint
   widths, count_chunk 8, and DenseNet-121, f32) with random weights from
   a numpy seed through the weight bridge (orthogonal Gaussian FAVOR
   projections) registers slide 0: its image grid (``/255`` crops at the
   spots, zeros elsewhere) and a sparse Poisson count grid over the
   gene2vec genes go through ``modeldir.scbert_transform`` and
   ``serving.register_mm_grid``, the FAVOR count set to 0 just before and
   required to be 3,744 just after (624 count chunks x 6 layers); the
   foreground must equal the mask, the labels the plain-version route's
   (the same model with FastAttention through the kernel's plain version)
   up to near-ties, and the count f's logits on three chunks must lie
   within 1e-3 of the plain route's; then ms/slide, spots/s and a
   torch.profiler table of one count chunk;
10. the ``register`` command's path at full width: phase 4's model
    directory written to disk by the port's ``save_model_dir`` and read back
    bit-equal; six slides saved as ``.npy`` in the order A A B A A B (A the
    4 slides, B slides 0 and 1 cut to 9,000 rows) through
    ``serving.register_slides`` with ``slide_batch`` 4 (the card has no PIL:
    ``SlideSource(decode=np.load)``), its counts set to 0 just before and
    read just after (the gather and the labels corrector must have
    launched), the yield order and ``stats`` those of the grouping rule,
    each slide's labels equal to ``reg(slide)`` up to near-ties and its
    foreground equal to the mask; then ``cli.main(["register", ...])`` over
    slides 0-3 (``ingest.decode_slide`` swapped for ``np.load``), each
    Loupe CSV naming phase 4's ``register_batch`` labels up to near-ties;
    the loop's wall ms/slide beside its stage times and phase 4's;
11. the count route at full width: a unified count cache of slide 0 over
    the 16,906 gene2vec genes (Poisson counts, written with ``gzip``) and a
    ``GridNetHex+CountMLP`` model directory through the ``register``
    command, the CSV's labels equal to the same model's forward on the CPU
    up to near-ties and the card's logits within 1e-3 of the CPU's; the
    cache's read time on the host and the forward's device time;
12. Visium HD at full width: a ``GridNet(TpuPatchClassifier)`` model
    directory (default arch, f32, 7 classes, the BatchNorm Cartesian
    corrector, ``grid_dims`` 384 x 384, 32-px patches, ``patch_chunk``
    1536, ``square_016um``) written by ``save_model_dir`` and read back
    bit-equal, once with ``window_px`` 32 and once with 58; positions
    parquets written by the port's writer and read by
    ``io.read_positions(srd, "square_016um")``; slide E (12,352 px square,
    pitch 32: plan ``"exact"``), slide F (22,577 px square, pitch 58.46 px,
    16 um at 0.2737 um/px: plan ``"resample"``) and J (E's lattice
    jittered by up to 3 px: no plan). E's ``register_dense`` goes through
    the per-bin route: the gather's count rises on it, and its labels equal
    ``reg(wsi, pos)``'s; F's resample launches no gather, its patches of
    four bands lie within 2e-2 of a float64 oracle of the exact bin extents
    (float32 sample positions, as the JAX package computes them, are read
    against the same oracle) and its labels equal the per-bin route's on at
    least 90 % of bins; every foreground equal to the tissue mask; the
    gather at windows 32 and 58 over every bin of E and F bit-exact against
    its plain version, timed against its bytes bound (events and a trace);
    each route's ms/slide and bins/s, a stage split and a torch.profiler
    table of each dense route; ``register_slides`` over E F J E
    (``slide_batch`` 4) and over F, and ``cli.main(["register", ...])``
    over E and F, their labels those of the direct calls;
13. the ``register`` command for every model kind, in-process
    (``cli.main(["register", ...])``, decode swapped for ``np.load``),
    the gather's and FAVOR's counts set to 0 just before each command and
    read just after: (a) phase 9's scBERT + DenseNet-121 directory with
    its scBERT cut to ``MM_STEP_DEPTH`` = 2 of its 6 layers (phase 9 runs
    all 6; the cut keeps the script inside its time limit) over slide 0's
    Spaceranger directory (phase 4's positions, a unified cache of phase
    9's raw counts under feature IDs, a MEX whose ``features.tsv.gz`` maps
    them to the gene2vec symbols): 1 gather launch, 1,248 FAVOR launches,
    the CSV naming the labels of the same model's direct forward on phase
    9's request inputs up to near-ties; (b) a CountMLP + TpuPatchClassifier directory at
    ``window_px`` 160 with ``log1p``, the labels those of a direct forward
    on the plain crop of the edge-padded slide plus the resize; (c) a 64 x
    64 lattice of 16 um bins at 32 px (a positions parquet, a binned
    unified cache) through ``GridNetMM`` per bin and with
    ``dense_ingest`` (labels equal) and ``GridNet+CountMLP``; (d) a
    ``HexGCN`` (hidden 128, depth 3) over slide 0's MEX, the labels those
    of the same weights on the CPU up to near-ties; every foreground equal
    to the tissue; each command's ms/slide, stage split and spots/s;
14. training at full width: (a) ``cli.main(["train-image", ...])`` with
    DenseNet-121 f and a GridNetHex g (128-px patches, batch 32,
    patch_chunk 624, grid batch 1) over phase 4's four slides as a cohort
    (8,514 in-tissue spots; each spot's window tinted by its class, 7-class
    Loupe CSVs of the tissue's angular sectors with 10 % of the labels
    redrawn from a numpy seed; slides as ``.npy``, decode swapped for
    ``np.load``), ``--epochs 1`` and then ``--resume --epochs 2``, the
    gather's count set to 0 before each and required to be one launch per
    spot batch and per grid; the written directory registered by the
    ``register`` command, its labels equal (up to near-ties) to a CPU
    forward of the same weights, and ``g_state.msgpack`` read back
    bit-equal; the epoch's first 64 spotwise steps timed (cut from the
    epoch's 213 for the time limit), and a traced epoch of 8 batches (cut
    from 20) for the device time a step of the crop, forward + backward and
    the optimiser (each kernel by the range its launch fell in) and the busy
    time a step, which split the untraced steps (the device's idle time
    the host's) and give their idle share; the grid step timed; (b) one spotwise DenseNet-121 step
    (batch 32) and one GridNetHex grid step with the frozen DenseNet-121 f
    over a 32 x 32 window of slide 0's grid (the CPU's f over a whole grid
    takes a minute), on the card and on the CPU from the same weights, and in float64 on
    the card as the reference: loss within 1e-4 relative and the updated
    BatchNorm statistics within 1e-4 absolute, card vs CPU; the card's
    gradients as exact as the CPU's against float64 (worst relative error
    at most twice the CPU's), and its updated parameters more than 1e-4
    from the float64 step no more often than twice the CPU's (float32
    resolves some BatchNorm-cancelled gradients only to ~1e-2 on either
    device, and Adam's first step moves those elements by up to lr; the
    elements more than 1e-4 apart, card vs CPU, are counted); (c)
    ``train_spotwise`` of scBERT at full width (16,906 genes, dim 200, depth
    6, 10 heads, dim_head 64, m 266; batch 8, 8 steps; weights from a numpy
    seed, the head's token scores centred on their mean), FAVOR's wrapper
    required to run 6 times a step (3 CUDA kernels each); one step's q/k/v
    projection gradients, kernel route against plain route: their median
    relative gap within the gap that the plain route with FAVOR's output
    perturbed by its forward tolerance (2e-4 relative) gives, a planted
    forward wrong by 1e-2 relative required to read at least twice that,
    and no projection further off than the planted fault's worst
    (``favor_gradient_gate``); then
    one ``train_gridwise`` step of phase 9's GridNetHexMM (scBERT +
    DenseNet-121, both frozen) over a full grid with its scBERT cut to
    ``MM_STEP_DEPTH`` = 2 of its 6 layers (phase 9 runs all 6 on the same
    weights; the cut keeps the script inside its time limit), 1,248 FAVOR
    calls; the phase's seconds and peak device memory, each number beside
    the card's name and power limit;
15. the count data tier at full transcriptome width: (a) the ``simulate``
    command (``cli.main``) makes a cohort of ``TIER_ARRAYS`` arrays at 16,906
    genes named by gene2vec symbols, timed; (b) the ``prepare`` command
    writes their unified caches, timed with its stage split (MEX read,
    union and filter, write); (c) the caches of the first
    ``TIER_READ_ARRAYS`` = 2 arrays (cut from 4) read three ways on the
    host clock, the codec's the median of 3, the yardstick's one read (cut
    from 3; both cuts for the time limit): the package's former line reader (kept here as
    ``line_reader``: ``gzip`` and one ``np.fromstring`` a row), the codec on
    the ``GX`` member chain, and the codec on a single-member copy written
    by ``write_unified_cache``, all three required equal; (d) the
    ``train-count`` command on the card, 2 epochs, its spot and grid
    stages timed, the grid stage's training loss required to fall from
    epoch 1 to epoch 2; (e) the ``register`` command for each array through
    the trained directory, the CSV's labels equal to a direct forward of
    the directory's model on the ``CountGridDataset`` grid up to near-ties,
    and the foreground accuracy against the simulated annotations printed;
    (f) two caches with reversed gene axes required to make the factory
    raise the gene-axis ``ValueError``; every number beside the card's name
    and power limit;
16. scBERT pretraining, fine-tuning and ``train-graph`` in phase 15's
    directory: (a) the ``pretrain-scbert`` command on array 0 (1,386
    spots, 16,906 gene2vec genes) at the checkpoint widths (dim 200, depth
    6, 10 heads, dim_head 64, m 266, N 16,907 tokens), batch 4, one epoch,
    ``--redraw-every 100``, no remat: FAVOR's wrapper count, set to 0 just
    before and read just after, required to be 6 x (train + val forwards);
    every projection buffer changed at each of the >= 2 redraws; the mean
    loss of the last 20 steps below that of the first 20;
    ``scbert_lm.msgpack`` read back bit-equal through ``_load_scbert_ckpt``;
    steps/s, tokens/s, the epoch's seconds and peak memory; (b) one MLM
    step on weights from a numpy seed and a corrupted batch of (a)'s
    corpus, kernel route against plain route: the loss within 1e-4
    relative, the q/k/v projection gradients within phase 14 (c)'s gate;
    the same step under remat: 12 FAVOR calls (6 layers x 2) and the
    gradients within 1e-6 relative of the step without remat; the gate's
    readings on (a)'s pretrained weights, logged and held to nothing; a traced
    window of 6 MLM steps for the device time of the FAVOR kernels, the
    GEMMs and the rest, and the device's idle share against (a)'s step;
    (c) the ``train-mm --scbert-ckpt --scbert-finetune`` start
    (``_load_scbert_ckpt`` + ``_merge_matching_params``) on a full-width
    scBERT: every checkpoint leaf bit-equal, only the head reported
    re-initialised; one finetune spot step (batch 8): every ``frozen`` leaf
    bit-unchanged, every ``train`` leaf moved (phase 14 (c) runs before (a)
    writes the checkpoint, so this is its own step); (d) the
    ``train-graph`` command over phase 15's 4 arrays (5,544 nodes, 16,906
    genes; 200 steps, hidden 64, depth 3): the loss falls, steps/s, and
    ``register`` of array 0 through the written directory equal to a
    direct forward up to near-ties; every number beside the card's name
    and power limit;
17. the ``evaluate`` and ``distill`` commands, run right after phase 14
    in its directory (its 4-array cohort, 8,514 annotated spots, 7
    classes, ``.npy`` slides, and its trained DenseNet-121 directory); the
    counts of the gather, the corrector and FAVOR set to 0 just before each
    command and read just after: (a) ``evaluate`` over the 4 arrays, one
    gather launch and one f call an array, its per-array label grids (taken
    from ``all_fgd_predictions``) equal to the registrar's labels on the
    same slides up to ``label_parity_report``'s near-ties, its truth grids
    equal to the annotations, its accuracy the grids', s per array;
    ``--tta`` (f run 8 times) and ``--f-only`` on
    array 0; (b) ``distill`` into the default bf16 ``TpuPatchClassifier``
    at batch 256 and the 15 % holdout, ``DISTILL_STEPS`` = 200 steps (cut
    from 2,000): steps/s and patches/s of the loop, the last 100-step
    chunk's loss below the first, the recorded ``label_agreement`` equal to
    the two registrars' recomputed, 1 + 2 x 4 gather and 2 x 4
    labels-corrector launches; ``register`` of the student directory (the
    CSVs its registrar's labels up to near-ties) and ``evaluate`` of both
    directories (consensus); (c) ``distill`` of phase 13 (a)'s scBERT (depth
    ``MM_STEP_DEPTH`` = 2) + DenseNet-121 directory over array 0's
    16,906-gene cache, 50 steps of batch 64 (cut from 2,000 of 256): FAVOR's
    count 2 x the teacher forwards (steps + the holdout's batches of 64), the
    written directory ``count_f: "mlp"`` with its image f and corrector
    bit-equal to the teacher's; the teacher on a 64-row chunk of the pool
    through the FAVOR kernel and through its plain version (its first
    layer's attention within FAVOR's tolerance of the float64 value on
    the 8 sequences farthest from the plain version, its logits within
    1e-3),
    and one 256-row chunk (the default ``--batch-size``, which also sets
    the holdout chunk) through the kernel, its peak memory and its first
    64 rows against the plain route; ``evaluate`` of teacher + student over
    array 0 (1,248 FAVOR calls); every number beside the card's name and
    power limit;
18. the serving surfaces, each path with the counts of the gather, the
    labels corrector and FAVOR set to 0 just before it and read just after:
    (a) ``serve``: phase 4's model directory (written by phase 10) in a
    ``RegistrationService`` behind ``make_server`` on 127.0.0.1 (port 0),
    a warm-up request and the metrics reset, then 2 rounds of 4
    concurrent ``POST /register`` (the 4 full-width slides, decode swapped
    for ``np.load``): every response 200, the micro-batcher required to
    have batched slides, one gather and one corrector launch a dispatch,
    the labels phase 4's up to near-ties, ``GET /metrics`` 200 and a
    request without ``spaceranger`` 400; warm ms per request (p50, max)
    and requests/s; in phase 15's directory a count request through the
    trained ``train-count`` directory, its labels the directory's forward
    up to near-ties; (b) ``export --wsi-shape`` of the same directory
    (the CLI default ``--n-spots`` 8192), the artifact loaded by
    ``load_artifact`` and called on the 4 slides: labels phase 4's up to
    near-ties, exactly one gather and one labels-corrector launch a call
    (the kernels, not the plain versions, inside the exported graph);
    the artifact's ms/slide against the live registrar's; ``serve-artifact``
    over 2 slides, its CSVs the ``register`` command's up to near-ties;
    (c) in phase 12's directory, ``export --dense`` of slide E's
    exact-pitch lattice (384 x 384 bins): labels ``register_dense``'s up to
    near-ties, one gather launch a call, its ms/slide against
    ``register_dense``'s; (d) in phase 13's directory, ``export`` of (a)'s
    scBERT (depth ``MM_STEP_DEPTH``) + DenseNet-121 directory, the
    artifact over slide 0 with the tissue mask as an input: labels phase
    13 (a)'s up to near-ties (no second live pass), FAVOR launched once a
    layer for each of the 624 count chunks; every time beside the card's
    name and power limit;
19. the parallel tier and the cohort workflows: (a) in phase 15's
    directory, ``train-count --mesh data=1`` over a 1-rank NCCL process
    group (``--coordinator 127.0.0.1:<free port>,1,0``, in-process), 1
    epoch over the 4-array 16,906-gene cohort, its files byte-equal to the
    same command's without a mesh, the parallel module's count of gradient
    all-reduces above 0 (apart from the host's stop flags; every count 0
    without a mesh); (b) in phase 14's directory, four processes at once
    on the card (cuDNN's deterministic algorithms): 2 gloo ranks, the
    single-process reference, and the witness, one process that runs the
    ranks' arithmetic without collectives (each step's two 16-row halves
    apart, their gradients summed). A ``TpuPatchClassifier`` spot stage
    (batch ``TRAIN_BATCH``, ``MESH_STEPS`` = 8 steps, slide 0's spots):
    the ranks bit-equal to each other; within 1e-6 relative (losses) and
    1e-6 abs + 1e-5 rel (every weight and first-step gradient) of the
    witness; against the reference, the first step's loss within 1e-6 and
    its gradients within 1e-4 of each tensor's largest, the 8 losses within
    1e-4 and at most ``MESH_WEIGHTS_OUT`` of the weights beyond 1e-4 abs +
    1e-3 rel; one gather launch a batch on each rank, and only rank 0's
    checkpoint directory written. Then one GridNetHex grid step (frozen
    TpuPatchClassifier f; g's BatchNorm over the global batch, one 32 x 32
    window a rank): loss within 1e-5, g's gradients within 1e-4 of each
    tensor's norm (zero true gradients left out), BatchNorm statistics
    within 1e-5 of the reference's. Then ``train_mlm`` of a PerformerLM at
    scBERT's widths (depth cut to 2), 2 steps of 4 rows with a FAVOR
    redraw after each, also in the witness: against the witness, losses
    within 1e-6 and step-1 gradients and projections within 1e-6 abs +
    1e-5 rel; against the reference (FAVOR's other split plan at 4 rows),
    both losses within 1e-5, the step-1 gradients within 1e-3 of each
    tensor's largest and the projections equal; FAVOR launched once a
    layer a step on each rank (a gloo refusal of a CUDA collective is
    printed and fails the run); (c) in phase 10's directory, phase 4's
    model directory as a ``SlideRegistrar(mesh=...)`` with 2 spot shards on
    the card over the 4 slides: one gather launch a shard and one labels
    corrector, labels phase 4's up to ``label_parity_report``'s near-ties,
    ms/slide against the unsharded registrar's; (d) in phase 15's
    directory, the PCA workflow: 2,000 highly variable genes over the 4
    caches, the cohort scaler, ``fit_pca`` on the card against a float64
    fit on the host: ``n_pcs`` at 0.5 variance equal, the leading ``n_pcs``
    components' cosines at least 1 - 1e-4 and ``explained_variance_ratio_``
    within 1e-5, each step's seconds; every number beside the card's name
    and power limit;
20. sequence parallelism, ``--profile-dir`` and a reference checkpoint:
    (a) ``train_mlm`` on ``{'data': 1, 'seq': 2}``, 2 gloo ranks sharing
    the card, against one process on the same card (3 processes at once):
    a PerformerLM at scBERT's widths (dim 200, 10 heads, dim_head 64, m
    266, depth cut to ``SEQ_MLM_DEPTH`` = 2), 4 rows of 16,906 + 1 tokens
    padded to 16,908 with a -1 column (the reference trains the padded
    corpus), ``SEQ_MLM_STEPS`` = 2 steps with a redraw after each: the
    ranks' weights bit-equal, the losses within 1e-5 relative and the
    step-1 gradients within 1e-3 of each tensor's largest of the
    reference's, the projections equal; each rank launches
    ``favor_accumulate_f32`` and ``favor_apply_f32`` once a layer a step
    and the fused entry never, the reference the fused entry only; then,
    in this process at a rank's shape (B 4, H 10, N 8,454, d 64, m 266),
    the accumulate followed by the apply without a sum bit-equal to the
    fused entry at the same split plan, ctx and ksum within 2e-5 + 2e-4 x
    the largest |plain value| and the apply within FAVOR's tolerance of
    their plain versions on the same inputs, each entry and the fused call
    timed (events) against its bound; (b) in phase 10's directory,
    ``cli.main(["--profile-dir", DIR, "register", ...])`` over slide 0 with
    phase 4's model directory: the Chrome trace under DIR holds CUDA kernel
    events of the gather and of the labels corrector, their counts set to
    0 just before and read just after; (c) phase 6's DenseNet-121 weights
    written as a reference-layout ``.pth`` (``torch.save`` of the
    reference's state-dict names), read back through
    ``read_torch_checkpoint`` and ``densenet_from_torch`` and registered on
    slide 0: labels equal to the ``from_jax`` route's, the gather and the
    labels corrector launched;
21. a ``{"kernels": [...]}`` line (FAVOR's row also carries
    ``launches_pretrain_scbert``, phase 16 (a)'s count; the gather,
    labels-corrector and FAVOR rows ``launches_evaluate`` and
    ``launches_distill``, phase 17's counts, ``launches_serve`` and
    ``launches_artifact``, phase 18's, and ``launches_mesh``, phase 19's;
    the gather and labels-corrector rows ``launches_profile_register`` and
    ``launches_torch_checkpoint``, phase 20 (b)'s and (c)'s; the rows of
    FAVOR's two halves, ``favor_accumulate`` and ``favor_apply``, carry
    phase 20 (a)'s launches on both ranks), then the last line ``{"ok":
    true, "device": {...}}``.

Parity phases run with TF32 off for cuDNN and matmuls. Imports only the
port, torch and numpy.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12      # f32 on the CUDA cores (no tensor cores)
TF32_FLOPS_PER_S = 495e12     # TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense

N_SLIDES = 4
PATCH = 128
PITCH = int(PATCH * 1.07)     # 136 px lattice pitch, 128 px margin
MARGIN = PATCH
N_CLASSES = 7
SEED = 0
TISSUE_FRACTIONS = (0.95, 0.8, 0.65, 0.5)   # elliptical masks, one per slide
CHUNK = 624                   # f's patch chunk (the JAX bench's)
WINDOW = 160                  # crop window of the resize phase
# DenseNet-121's dense blocks at 128-px patches: (side, c_in0, layers)
DENSE_BLOCKS = ((32, 64, 6), (16, 128, 12), (8, 256, 24), (4, 512, 16))
GROWTH = 32
# scBERT at its checkpoint widths as train-mm builds it (generalized ReLU
# attention, m = 266 features), over the 16,906 gene2vec genes
MM_VOCAB = 16906
MM_DIM, MM_DEPTH, MM_HEADS, MM_DIM_HEAD = 200, 6, 10, 64
COUNT_CHUNK = 8               # train-mm's count_chunk for an scBERT count f
COUNT_RATE = 0.05             # Poisson mean per gene of the count grid (~845 a spot)
B_ROWS = 9000                 # rows of the cut slides of phase 10's mixed-shape cohort
FAVOR_RTOL, FAVOR_ATOL = 2e-4, 2e-5   # tests/test_favor_pallas.py's tolerance
# Label near-tie budget of the bf16 fused f against the f32 module: a flip
# is tolerated where the f32 route's top-2 corrector logits are within 5 %
# (the CPU tests' budget for the fused f against JAX's)
BF16_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> tuple:
    """(ms per call on the stream between CUDA events, ms per call the host
    took to issue it) of ``fn``, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


# CUDA kernel of each ported function, as the profiler names it
KERNEL_SYMBOLS = {"gather_patches": ("gather_bulk_kernel",),
                  "fused_hex_corrector": ("hex_corrector_kernel",),
                  "fused_hex_corrector_labels": ("hex_corrector_kernel",),
                  "fused_dense_block": ("dense_layer_kernel",),
                  "fused_generalized_linear_attention": (
                      "favor_accum_kernel", "favor_reduce_kernel", "favor_apply_kernel")}


def sass_count(path: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of the built library ``path``
    (``cuobjdump`` from ``nvcc``'s toolkit)."""
    from gridnext_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return sum(f" {opcode}." in line or f" {opcode} " in line for line in out.splitlines())


def traced_kernels(prof, symbols, calls: int) -> dict:
    """{symbol: (launches per call, device ms per call)} of the CUDA kernels
    named ``symbols`` (plain or templated) in a torch.profiler trace of
    ``calls`` calls. A long trace may drop a kernel event, so a call's time
    is the mean time of a launch times the launches per call (the traced
    count over ``calls``, rounded)."""
    found = {}
    for evt in prof.key_averages():
        for sym in symbols:
            if f"{sym}(" in evt.key or f"{sym}<" in evt.key:
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                n, t = found.get(sym, (0, 0.0))
                found[sym] = (n + evt.count, t + us)
    missing = [s for s in symbols if s not in found or found[s][1] <= 0]
    if missing:
        names = [e.key[:60] for e in prof.key_averages()][:30]
        raise AssertionError(f"no device time for {missing} in the trace; "
                             f"events: {names}")
    per_call = {s: max(1, round(n / calls)) for s, (n, _) in found.items()}
    return {s: (per_call[s], us / n / 1e3 * per_call[s]) for s, (n, us) in found.items()}


def profiled(torch, fn, iters: int, symbol_sets, tries: int = 3) -> tuple:
    """(prof, [:func:`traced_kernels` of each of ``symbol_sets``]) of
    ``iters`` back-to-back calls of ``fn``, recorded in the second of two
    profiler steps. The first step's record is discarded: it takes the
    tracer's activity-buffer requests, and in a process that has traced
    before, a short trace that takes one itself has come back with the
    launches but no kernel records. A trace that still lacks a kernel's
    records is taken again, at most ``tries`` times in all, and each loss is
    logged: the launch counters, not the trace, show that a kernel ran."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        try:
            return prof, [traced_kernels(prof, symbols, iters) for symbols in symbol_sets]
        except AssertionError as err:
            if attempt == tries:
                raise
            log(f"trace {attempt} of {tries} lost kernel records, tracing again: {err}")


def device_ms(torch, fn, iters: int, symbols) -> dict:
    """:func:`traced_kernels` of ``iters`` back-to-back calls of ``fn``
    (:func:`profiled`)."""
    return profiled(torch, fn, iters, [symbols])[1][0]


def kernel_line(per_symbol: dict) -> tuple:
    """(device ms per call, text) of :func:`traced_kernels`' result."""
    total = sum(ms for _, ms in per_symbol.values())
    parts = ", ".join(f"{s} {n:g} x {ms / n * 1e3:.2f} us" for s, (n, ms)
                      in per_symbol.items())
    return total, parts


def lattice(geometry):
    """(row, col_oddr, y_px, x_px) of the 78 x 64 spots at the bench pitch."""
    rows = np.repeat(np.arange(geometry.VISIUM_H_ST), geometry.VISIUM_W_ST)
    cols = np.tile(np.arange(geometry.VISIUM_W_ST), geometry.VISIUM_H_ST)
    x, y = geometry.oddr_to_cartesian(cols, rows)
    return (rows, cols, np.rint(y * PITCH).astype(np.int64) + MARGIN,
            np.rint(x * PITCH).astype(np.int64) + MARGIN)


def make_slides(torch, n, h, w, device, block: int = 64, noise: int = 256):
    """Random slides with structure: ``block``-px colour blocks plus pixel
    noise in [0, ``noise``), each at half amplitude."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    bh, bw = -(-h // block), -(-w // block)
    blocks = torch.randint(0, 256, (n, bh, bw, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    slides = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        big = blocks[i].repeat_interleave(block, 0).repeat_interleave(block, 1)[:h, :w]
        pixels = torch.randint(0, noise, (h, w, 3), dtype=torch.uint8, device=device,
                               generator=gen)
        slides[i] = big // 2 + pixels // 2
    return slides


def library_gather(view, s, yy, xx):
    """The crop as one PyTorch call: indexing ``view``, the zero-copy
    ``(B, H', W', w, w, 3)`` window view of :func:`window_view`, at clamped
    slides ``s`` and corners ``yy``, ``xx`` (a yardstick the port never
    calls)."""
    return view[s, yy, xx]


def window_view(imgs, window: int):
    """Every ``window x window`` crop of ``(B, H, W, 3)`` slides as a strided
    view (no copy)."""
    return imgs.unfold(1, window, 1).unfold(2, window, 1).permute(0, 1, 2, 4, 5, 3)


def clamped(y0, x0, slide, b, h, w, window):
    """Corners and slide ids clamped as the kernel clamps them (int64)."""
    return (y0.long().clamp(0, h - window), x0.long().clamp(0, w - window),
            slide.long().clamp(0, b - 1))


def gather_cases(torch, gather, slides):
    """Every source offset mod 16 at windows of the byte path (24, 97) and
    the bulk-copy path (128, 160), from the stack and from a slide view that
    starts off a 16-byte boundary; bit-exact. Returns the windows checked."""
    b, h, w, _ = slides.shape
    dev = slides.device
    for win in (24, 97, PATCH, WINDOW):
        offsets = set()
        for imgs in (slides, slides[1:]):
            nb = imgs.shape[0]
            # 16 consecutive corners of one row (3 x0 runs through every
            # residue mod 16), then corners spread over the slides
            i = torch.arange(48, device=dev, dtype=torch.int32)
            x0 = torch.where(i < 16, 100 + i, i * 37 + 11)
            y0 = torch.where(i < 16, 200, (i * 191) % (h - win))
            s = torch.where(i < 16, 1 % nb, i % nb)
            y0 = torch.cat([y0, torch.tensor([-7, h, 3], dtype=torch.int32, device=dev)])
            x0 = torch.cat([x0, torch.tensor([w, -1, w - win - 3], dtype=torch.int32,
                                             device=dev)])
            s = torch.cat([s, torch.tensor([nb + 2, -1, 0], dtype=torch.int32, device=dev)])
            yy, xx, ss = clamped(y0, x0, s, nb, h, w, win)
            offsets |= {(imgs.data_ptr() + 3 * ((a * h + c) * w + d)) % 16
                        for a, c, d in zip(ss.tolist(), yy.tolist(), xx.tolist())}
            before = gather.byte_launches
            got = gather.gather_patches(imgs, y0, x0, win, s)
            want = gather.gather_patches_plain(imgs, y0, x0, win, s)
            if not torch.equal(got, want):
                raise AssertionError(f"gather kernel at window {win} differs from plain")
            if gather.byte_launches - before != (not gather.bulk(win)):
                raise AssertionError(f"gather at window {win} took the wrong path")
        if offsets != set(range(16)):
            raise AssertionError(f"window {win}: source offsets {sorted(offsets)}")
    log("gather: windows 24, 97 (byte path), 128, 160 (bulk-copy path) bit-exact at every "
        "source offset mod 16, aligned and offset slide views, clamped corners and ids")


def phase_gather(torch, slides, geometry, gather):
    log("== phase 2: patch-gather kernel")
    b, h, w, _ = slides.shape
    _, _, y_px, x_px = lattice(geometry)
    y0 = np.tile(y_px - PATCH // 2, b)
    x0 = np.tile(x_px - PATCH // 2, b)
    slide = np.repeat(np.arange(b), len(y_px))
    # edge corners (clamped), parked-spot corners, out-of-range slide ids
    y0 = np.concatenate([y0, [-50, h, h - 100, 5, 0, 0, 17, 9000]])
    x0 = np.concatenate([x0, [-50, w, 5, w - 10, 0, 0, 8800, -7]])
    slide = np.concatenate([slide, [0, 3, 1, 2, 0, 1, -1, 9]])
    dev = slides.device
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in (y0, x0, slide)]
    n = len(y0)
    out = gather.gather_patches(slides, args[0], args[1], PATCH, args[2])
    plain = gather.gather_patches_plain(slides, args[0], args[1], PATCH, args[2])
    torch.cuda.synchronize()
    err = int((out.int() - plain.int()).abs().max().item())
    if not torch.equal(out, plain):
        raise AssertionError(f"gather kernel differs from plain (max abs {err})")
    # the single-call library form, clamped outside the timed call
    view = window_view(slides, PATCH)
    yy, xx, ss = clamped(*args, b, h, w, PATCH)
    idx = (ss, yy, xx)
    if not torch.equal(library_gather(view, *idx), plain):
        raise AssertionError("the library form of the crop differs from plain")
    del plain
    gather_cases(torch, gather, slides)

    def kernel():
        return gather.gather_patches(slides, args[0], args[1], PATCH, args[2])

    ms, host_ms = cuda_ms(torch, kernel, iters=20)
    dev_ms, parts = kernel_line(device_ms(torch, kernel, 10,
                                          KERNEL_SYMBOLS["gather_patches"]))
    plain_ms, _ = cuda_ms(torch, lambda: gather.gather_patches_plain(
        slides, args[0], args[1], PATCH, args[2]), iters=3, warmup=1)
    library_ms, _ = cuda_ms(torch, lambda: library_gather(view, *idx), iters=20)
    nbytes = 2 * n * PATCH * PATCH * 3 + 3 * n * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"gather: N={n} window={PATCH}: bit-exact; kernel {ms:.4f} ms per call "
        f"(events; host issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} "
        f"ms ({parts}), plain {plain_ms:.4f} ms, library (one aten::index on the "
        f"unfold view) {library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {nbytes}); "
        f"{bound_ms / ms * 100:.1f} % of the bound")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def corrector_work(b, c_in, n_classes, width=32, h=78, w=64):
    """(flops, bytes) of the 5-layer corrector on b grids."""
    dims = (c_in, width, width, width, width, n_classes)
    macs = sum(7 * dims[i] * dims[i + 1] for i in range(5))
    weights = sum(7 * dims[i] * dims[i + 1] + dims[i + 1] for i in range(5))
    return 2 * b * h * w * macs, b * h * w * c_in * 4 + weights * 4


def phase_corrector(torch, corr, serving, dev):
    log("== phase 3: hex-corrector kernels")
    rng = np.random.default_rng(SEED + 1)
    dims = (N_CLASSES, 32, 32, 32, 32, N_CLASSES)
    kernels = [rng.normal(size=(7, dims[i], dims[i + 1])).astype(np.float32)
               / np.sqrt(7 * dims[i]) for i in range(5)]
    biases = [rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1
              for i in range(5)]
    kernels = corr.as_f32_tensors(kernels, dev)
    biases = corr.as_f32_tensors(biases, dev)
    flags = corr.CORRECTOR_RELU_FLAGS
    x = torch.as_tensor(rng.normal(size=(N_SLIDES, 78, 64, N_CLASSES))
                        .astype(np.float32), device=dev)
    fg = torch.as_tensor((rng.random((N_SLIDES, 78, 64)) < 0.7).astype(np.int32),
                         device=dev)
    for k in corr.launches:
        corr.launches[k] = 0
    logits = corr.fused_hex_corrector(x, kernels, biases, flags)
    plain = corr.hex_corrector_plain(x, kernels, biases, flags)
    labels = corr.fused_hex_corrector_labels(x, fg, kernels, biases, flags)
    plain_labels = corr.hex_corrector_labels_plain(x, fg, kernels, biases, flags)
    torch.cuda.synchronize()
    if dict(corr.launches) != {"fused_hex_corrector": 1, "fused_hex_corrector_labels": 1}:
        raise AssertionError(f"corrector launches per wrapper call: {corr.launches}")
    err = float((logits - plain).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"corrector logits differ from plain by {err}")
    flips = sum(serving.label_parity_report(plain_labels[i].cpu().numpy(),
                                            labels[i].cpu().numpy(),
                                            plain[i].cpu().numpy())
                for i in range(N_SLIDES))
    label_err = int((labels - plain_labels).abs().max().item())
    # beyond the per-layer kernel's limits: 33 and 64 classes, c_in 1024 (layer 0's weights
    # 917 KB), each in one launch a call
    for c_in, n_cls in ((N_CLASSES, 33), (1024, 64)):
        wide = (c_in, 32, 32, 32, 32, n_cls)
        ks = corr.as_f32_tensors([rng.normal(size=(7, wide[i], wide[i + 1])).astype(np.float32)
                                  / np.sqrt(7 * wide[i]) for i in range(5)], dev)
        bs = corr.as_f32_tensors([rng.normal(size=(wide[i + 1],)).astype(np.float32) * 0.1
                                  for i in range(5)], dev)
        xw = torch.as_tensor(rng.normal(size=(N_SLIDES, 78, 64, c_in)).astype(np.float32),
                             device=dev)
        before = dict(corr.launches)
        got = corr.fused_hex_corrector(xw, ks, bs, flags)
        got_labels = corr.fused_hex_corrector_labels(xw, fg, ks, bs, flags)
        want = corr.hex_corrector_plain(xw, ks, bs, flags)
        want_labels = corr.hex_corrector_labels_plain(xw, fg, ks, bs, flags)
        torch.cuda.synchronize()
        if {k: corr.launches[k] - before[k] for k in before} != {
                "fused_hex_corrector": 1, "fused_hex_corrector_labels": 1}:
            raise AssertionError(f"corrector at c_in {c_in}, {n_cls} classes: launches "
                                 f"{corr.launches} from {before}")
        e = float((got - want).abs().max().item())
        if not e <= 1e-4:
            raise AssertionError(f"corrector at c_in {c_in}, {n_cls} classes: logits "
                                 f"differ from plain by {e}")
        f = sum(serving.label_parity_report(want_labels[i].cpu().numpy(),
                                            got_labels[i].cpu().numpy(),
                                            want[i].cpu().numpy())
                for i in range(N_SLIDES))
        log(f"corrector c_in {c_in}, {n_cls} classes: logits max abs err {e:.3g}, labels "
            f"equal up to {f} near-tie flips, one launch a call")
    flops, nbytes = corrector_work(N_SLIDES, N_CLASSES, N_CLASSES)
    res = {}
    for name, fn, plain_fn, out_bytes in (
            ("fused_hex_corrector",
             lambda: corr.fused_hex_corrector(x, kernels, biases, flags),
             lambda: corr.hex_corrector_plain(x, kernels, biases, flags),
             N_SLIDES * 78 * 64 * N_CLASSES * 4),
            ("fused_hex_corrector_labels",
             lambda: corr.fused_hex_corrector_labels(x, fg, kernels, biases, flags),
             lambda: corr.hex_corrector_labels_plain(x, fg, kernels, biases, flags),
             N_SLIDES * 78 * 64 * 4 * 2)):   # fg in + labels out
        ms, host_ms = cuda_ms(torch, fn, iters=50)
        dev_ms, parts = kernel_line(device_ms(torch, fn, 50, KERNEL_SYMBOLS[name]))
        plain_ms, _ = cuda_ms(torch, plain_fn, iters=10)
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        t_bytes = (nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"{name}: B={N_SLIDES}: kernel {ms:.4f} ms per call (events; host "
            f"issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} ms "
            f"({parts}), plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.5f} "
            f"ms ({flops / 1e6:.1f} MFLOP, {nbytes + out_bytes} bytes)")
    res["fused_hex_corrector"]["max_abs_err"] = err
    res["fused_hex_corrector_labels"]["max_abs_err"] = label_err
    log(f"corrector: logits max abs err {err:.3g} (<= 1e-4), labels equal up to "
        f"{flips} near-tie flips")
    return res


def write_spaceranger_dir(root, geometry, frac: float, idx: int):
    """Write a Spaceranger v2 positions file for one slide: an elliptical
    tissue mask of relative size ``frac`` over the bench lattice. Returns
    (the Spaceranger directory, the (78, 64) tissue mask); spot ``i`` of the
    file is odd-right cell ``divmod(i, 64)``."""
    rows, cols, y_px, x_px = lattice(geometry)
    cx, cy = geometry.oddr_to_cartesian(cols, rows)
    rx = (cx.max() - cx.min()) / 2 * frac
    ry = (cy.max() - cy.min()) / 2 * frac
    r2 = ((cx - cx.mean()) / rx) ** 2 + ((cy - cy.mean()) / ry) ** 2
    in_tissue = (r2 <= 1.0).astype(np.int64)
    array_col, array_row = geometry.oddr_to_pseudo_hex(cols, rows)
    sr_dir = os.path.join(root, f"slide{idx}")
    os.makedirs(os.path.join(sr_dir, "outs", "spatial"))
    with open(os.path.join(sr_dir, "outs", "spatial", "tissue_positions.csv"), "w",
              newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["barcode", "in_tissue", "array_row", "array_col",
                      "pxl_row_in_fullres", "pxl_col_in_fullres"])
        out.writerows([f"S{idx}BC{i:05d}-1", *vals] for i, vals in enumerate(
            zip(in_tissue, array_row, array_col, y_px, x_px)))
    return sr_dir, in_tissue.reshape(geometry.VISIUM_H_ST, geometry.VISIUM_W_ST)


def random_variables(models, from_jax, f=None, seed=SEED + 2, model=None):
    """A variables tree in the JAX package's layout, filled from a numpy
    seed (what a JAX model directory's checkpoint holds), for ``model``
    (default: a GridNetHex with the BatchNorm corrector and f, by default
    the default-width TpuPatchClassifier). FAVOR projections are orthogonal
    Gaussian matrices, as a checkpoint's ``favor`` collection holds. Token
    embeddings are unit normals (torch's ``nn.Embedding`` init): at 0.1
    scale the linear attention's near-global average swamps the tokens,
    every position of scBERT's last LayerNorm is the same vector and its
    classifier outputs constant logits, blind to the attention."""
    import torch

    from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

    if model is None:
        f = f if f is not None else models.TpuPatchClassifier(n_classes=N_CLASSES)
        model = models.GridNetHex(f, n_classes=N_CLASSES, f_dim=N_CLASSES, use_bn=True)
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "projection":
                gen = torch.Generator().manual_seed(int(rng.integers(2 ** 31)))
                out[key] = orthogonal_gaussian_matrix(*val.shape, generator=gen).numpy()
            elif key == "embedding":
                out[key] = rng.normal(size=val.shape).astype(np.float32)
            elif key == "kernel":
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.normal(size=val.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif key == "scale":
                out[key] = rng.uniform(0.8, 1.2, val.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:   # bias, mean
                out[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        return out

    return fill(from_jax.jax_variables(model))


def check_loupe_csv(path, labels, classes, n_spots):
    """The Loupe CSV names each in-tissue spot's class from ``labels``."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if rows[0] != ["Barcode", "AARs"] or len(rows) != n_spots + 1:
        raise AssertionError(f"Loupe CSV: header {rows[0]}, {len(rows) - 1} rows "
                             f"for {n_spots} in-tissue spots")
    for barcode, annot in rows[1:]:
        spot = int(barcode.split("BC")[1].split("-")[0])
        y, x = divmod(spot, labels.shape[1])
        if annot != classes[labels[y, x] - 1]:
            raise AssertionError(f"Loupe CSV: {barcode} is {annot!r}, label "
                                 f"{labels[y, x]}")


def plain_registrar_class(serving, gather, corr):
    """A ``SlideRegistrar`` subclass with each kernel's plain version in its
    place."""

    class PlainRegistrar(serving.SlideRegistrar):
        def _extract_flat(self, wsis, y_c, x_c, slide):
            w = self.window_size
            return gather.gather_patches_plain(wsis, y_c - w // 2, x_c - w // 2, w,
                                               slide)

        def _labels_from_grid(self, grid, fg):
            return corr.hex_corrector_labels_plain(grid, fg, self.kernels,
                                                   self.biases, self.relu_flags)

        def _register_logits(self, wsi, oy, ox, y_px, x_px):
            grid, fg = self._grid_fg(wsi[None], oy[None], ox[None], y_px[None],
                                     x_px[None])
            logits = corr.hex_corrector_plain(grid, self.kernels, self.biases,
                                              self.relu_flags)
            return logits[0].float(), fg[0]

    return PlainRegistrar


def phase_main_path(torch, slides, port, card, tmp):
    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log("== phase 4: main path at full width (TF32 off for cuDNN and matmuls)")
    dev = slides.device
    meta = {"model": "GridNetHex+TpuPatchClassifier",
            "classes": [f"Class_{i + 1}" for i in range(N_CLASSES)],
            "tpu_f": {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"},
            "patch_px": PATCH, "patch_chunk": 624}
    classes = meta["classes"]
    variables = random_variables(models, from_jax)
    dirs_masks = [write_spaceranger_dir(tmp, geometry, f, i)
                  for i, f in enumerate(TISSUE_FRACTIONS)]
    masks = [m for _, m in dirs_masks]
    n_spots = [int(m.sum()) for m in masks]
    log(f"in-tissue spots per slide: {n_spots}")
    # the model-directory route (normalize=None: /255 only)
    reg = modeldir.image_registrar_from_meta(meta, classes, variables, device=dev)
    positions = [io.read_positions(d) for d, _ in dirs_masks]

    gather.launches = 0
    for k in corr.launches:
        corr.launches[k] = 0
    labels0 = reg(slides[0], positions[0])
    logits1, fg1 = reg.register_logits(slides[1], positions[1])
    labels_b = reg.register_batch(slides, positions)
    torch.cuda.synchronize()
    launches = {"gather_patches": gather.launches, **corr.launches}
    log(f"main-path kernel launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # what comes out: shapes, finite logits, foreground == tissue masks
    if labels0.shape != (78, 64) or labels_b.shape != (N_SLIDES, 78, 64):
        raise AssertionError(f"label shapes {labels0.shape} {labels_b.shape}")
    if not np.isfinite(logits1).all() or logits1.shape != (78, 64, N_CLASSES):
        raise AssertionError("register_logits gave non-finite or misshapen logits")
    for got, mask in [(labels0 > 0, masks[0]), (fg1 > 0, masks[1])] + [
            (labels_b[i] > 0, masks[i]) for i in range(N_SLIDES)]:
        if not np.array_equal(got, mask > 0):
            raise AssertionError("foreground differs from the tissue mask")
    if labels_b.max() > N_CLASSES:
        raise AssertionError(f"label {labels_b.max()} out of range")
    loupe = os.path.join(tmp, "slide0_labels.csv")
    evaluate.to_loupe_annots(labels0, io.find_position_file(dirs_masks[0][0]), loupe,
                             annot_names=classes)
    check_loupe_csv(loupe, labels0, classes, n_spots[0])
    log(f"Loupe CSV of slide 0: {n_spots[0]} spots, classes match the label grid")

    # the same model through the same weight bridge, with the plain versions
    PlainRegistrar = plain_registrar_class(serving, gather, corr)
    f = models.TpuPatchClassifier(n_classes=N_CLASSES,
                                  **models.tpu_f_arch_kwargs(meta["tpu_f"]))
    model = from_jax.load_gridnet(
        models.GridNetHex(f, n_classes=N_CLASSES, f_dim=N_CLASSES), variables)
    model = model.to(dev).eval()
    plain = PlainRegistrar.from_gridnet(model, patch_size=PATCH, patch_chunk=624,
                                        normalize=None, device=dev)
    plain_logits = [plain.register_logits(slides[i], positions[i])[0]
                    for i in range(N_SLIDES)]
    flips = serving.label_parity_report(plain(slides[0], positions[0]), labels0,
                                        plain_logits[0])
    plain_b = plain.register_batch(slides, positions)
    for i in range(N_SLIDES):
        flips += serving.label_parity_report(plain_b[i], labels_b[i], plain_logits[i])
    logit_err = float(np.abs(logits1 - plain_logits[1]).max())
    if not logit_err <= 1e-4:
        raise AssertionError(f"register_logits differs from plain by {logit_err}")
    log(f"kernels vs plain registrar: labels equal up to {flips} near-tie flips, "
        f"logits max abs err {logit_err:.3g}")

    # an independent reference: GridNetHex forward on the patch grid of slide 1
    # (background cells are zero patches, as in training grids)
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(positions[1])
    crops = gather.gather_patches_plain(
        slides[1], torch.as_tensor(y_px - PATCH // 2, device=dev),
        torch.as_tensor(x_px - PATCH // 2, device=dev), PATCH)
    grid = torch.zeros((78, 64, PATCH, PATCH, 3), device=dev)
    grid[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        crops.float() / 255.0
    model.patch_chunk = 624
    with torch.inference_mode():
        ref = model(grid[None])[0].cpu().numpy()
    ref_err = float(np.abs(ref - logits1).max())
    if not ref_err <= 1e-3:
        raise AssertionError(f"register_logits differs from the GridNetHex "
                             f"forward by {ref_err}")
    log(f"register_logits vs GridNetHex forward: max abs err {ref_err:.3g}")
    del grid, crops

    # end-to-end time of register_batch (host clock, results on the host), the
    # kernels' registrar and the plain one in turns: k p p k k p p k
    times = {"kernels": [], "plain": []}
    for r in (reg, plain):
        r.register_batch(slides, positions)
    for name in ("kernels", "plain", "plain", "kernels") * 2:
        r = reg if name == "kernels" else plain
        t0 = time.perf_counter()
        r.register_batch(slides, positions)
        times[name].append(time.perf_counter() - t0)
    t, t_plain = (float(np.median(times[k])) for k in ("kernels", "plain"))
    log(f"register_batch of {N_SLIDES} slides ({sum(n_spots)} spots), f32 without "
        f"TF32, median of 4: {t * 1e3 / N_SLIDES:.2f} ms/slide, "
        f"{sum(n_spots) / t:.0f} spots/s with the kernels (runs "
        f"{[round(x * 1e3, 2) for x in times['kernels']]} ms); "
        f"{t_plain * 1e3 / N_SLIDES:.2f} ms/slide with "
        f"the plain versions [{card}]")
    return launches, reg, positions, masks, {"labels_b": labels_b,
                                             "ms_per_slide": t * 1e3 / N_SLIDES}


def profile_batch(torch, reg, slides, positions,
                  names=("gather_patches", "fused_hex_corrector_labels")):
    prof, traced = profiled(torch, lambda: reg.register_batch(slides, positions), 1,
                            [KERNEL_SYMBOLS[name] for name in names])
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    for name, per_symbol in zip(names, traced):
        dev_ms, parts = kernel_line(per_symbol)
        log(f"register_batch trace: {name} device {dev_ms:.4f} ms ({parts})")


def dense_layer_floor_bytes(b, side, c0, n_layers, growth=GROWTH):
    """Bytes a layer-at-a-time block must move on b patches: each layer reads
    its c_in bf16 channels and writes its growth."""
    m = b * side * side
    return sum(2 * m * (c0 + l * growth + growth) for l in range(n_layers))


def dense_block_work(b, side, c0, n_layers, cb, growth=GROWTH):
    """(flops, bytes) of one dense block on b patches: written channels only;
    bytes = bf16 input and output once, plus the bf16 weights and f32
    affines the layers read."""
    m = b * side * side
    c_ins = [c0 + l * growth for l in range(n_layers)]
    flops = sum(2 * m * c * cb + 2 * m * 9 * cb * growth for c in c_ins)
    weights = sum(2 * c * cb + 8 * c + 2 * 9 * cb * growth + 8 * cb for c in c_ins)
    c_max = c0 + n_layers * growth
    return flops, 2 * m * (c0 + c_max) + weights


def folded_blocks(dense, f_vars):
    """The four blocks' folded params of a DenseNet-121 tree (numpy)."""
    params, stats = f_vars["params"], f_vars["batch_stats"]
    out, k = [], 0
    for side, c0, n_layers in DENSE_BLOCKS:
        names = [f"_DenseLayer_{k + j}" for j in range(n_layers)]
        k += n_layers
        out.append(dense.fold_dense_block_params([params[n] for n in names],
                                                 [stats[n] for n in names], c0, GROWTH))
    return out


def cudnn_block(torch, F, x, w1, w2, a1, b1, a2, b2, c0, growth):
    """The same block as eager bf16 cuDNN convolutions in channels-last, one
    ``F.conv2d`` per conv and a concat per layer: a yardstick only. ``w1``,
    ``w2``: per-layer OIHW bf16 weights; the affines are bf16 too."""
    buf = x.permute(0, 3, 1, 2)                      # NCHW view, NHWC memory
    for l, (k1, k3) in enumerate(zip(w1, w2)):
        c_in = c0 + l * growth
        t = torch.relu(buf * a1[l, :c_in, None, None] + b1[l, :c_in, None, None])
        u = torch.relu(F.conv2d(t, k1) * a2[l, :, None, None] + b2[l, :, None, None])
        buf = torch.cat([buf, F.conv2d(u, k3, padding=1)], dim=1)
    return buf


def phase_dense_block(torch, dense, f_vars, dev):
    import torch.nn.functional as F

    log(f"== phase 5: dense-block kernel, DenseNet-121 blocks at B = {CHUNK}")
    rng = np.random.default_rng(SEED + 3)
    res = {}
    for bi, ((side, c0, n_layers), fold) in enumerate(
            zip(DENSE_BLOCKS, folded_blocks(dense, f_vars)), start=1):
        a1, b1, a2, b2 = (torch.as_tensor(fold[k], device=dev)
                          for k in ("A1", "B1", "A2", "B2"))
        w1, w2 = (torch.as_tensor(fold[k], device=dev).to(torch.bfloat16)
                  for k in ("W1", "W2"))
        x = torch.as_tensor(rng.normal(size=(CHUNK, side, side, c0)).astype(np.float32),
                            device=dev).to(torch.bfloat16)
        args = (x, a1, b1, w1, a2, b2, w2)

        def kernel():
            return dense.fused_dense_block(*args, c_in0=c0, growth=GROWTH)

        def plain():
            return dense.fused_dense_block_plain(*args, c_in0=c0, growth=GROWTH)

        got, want = kernel().float(), plain().float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max().item())
        differ = float((got != want).float().mean().item())
        close = torch.allclose(got, want, rtol=3e-2, atol=3e-2)
        corr = float(np.corrcoef(got.cpu().numpy().ravel()[::7],
                                 want.cpu().numpy().ravel()[::7])[0, 1])
        if not (close and corr > 0.999 and torch.isfinite(got).all()):
            raise AssertionError(f"dense block {bi}: kernel differs from plain (max "
                                 f"abs {err}, corr {corr})")
        del got, want
        iters = 20 if bi > 1 else 10
        ms, host_ms = cuda_ms(torch, kernel, iters=iters)
        dev_ms, parts = kernel_line(device_ms(torch, kernel, iters,
                                              KERNEL_SYMBOLS["fused_dense_block"]))
        plain_ms, _ = cuda_ms(torch, plain, iters=2, warmup=1)
        # the yardstick: OIHW channels-last bf16 weights, bf16 affines
        w1c = [w1[l, :c0 + GROWTH * l].t().contiguous()[:, :, None, None]
               for l in range(n_layers)]
        w2c = [w2[l].reshape(3, 3, -1, GROWTH).permute(3, 2, 0, 1)
               .contiguous(memory_format=torch.channels_last) for l in range(n_layers)]
        aff = [t.to(torch.bfloat16) for t in (a1, b1, a2, b2)]
        cudnn_ms, _ = cuda_ms(torch, lambda: cudnn_block(
            torch, F, x, w1c, w2c, *aff, c0, GROWTH), iters=iters)
        flops, nbytes = dense_block_work(CHUNK, side, c0, n_layers, w1.shape[-1])
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        floor_bytes = dense_layer_floor_bytes(CHUNK, side, c0, n_layers)
        t_floor = max(t_ops, floor_bytes / HBM_BYTES_PER_S * 1e3)
        res[bi] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                   "host_ms": host_ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "layer_floor_ms": t_floor, "cudnn_ms": cudnn_ms}
        log(f"dense block {bi} ({side}x{side}, {c0} -> {c0 + GROWTH * n_layers}, L = "
            f"{n_layers}): max abs err {err:.4g}, {differ * 100:.2f} % of elements "
            f"differ, corr {corr:.6f}; kernel {ms:.4f} ms per call (events; host "
            f"issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} ms ({parts}), "
            f"plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> "
            f"{t_bytes:.4f} ms); layer-at-a-time floor {t_floor:.4f} ms ({floor_bytes / 1e9:.3f} "
            f"GB read and written -> {floor_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
            f"yardstick: eager bf16 cuDNN sequence {cudnn_ms:.4f} ms")
    # shapes the wgmma kernel alone refused: growth 12 (the JAX DenseNet's default;
    # widths padded to multiples of 8) and growth 48 / Cb 192 (the general route)
    for side, c0, n_layers, growth, cb in ((16, 24, 6, 12, 48), (8, 64, 4, 48, 192)):
        wr = np.random.default_rng(SEED + 6 + growth)
        c_max = c0 + n_layers * growth
        a1 = wr.uniform(0.8, 1.2, (n_layers, c_max)).astype(np.float32)
        b1 = (wr.normal(size=(n_layers, c_max)) * 0.1).astype(np.float32)
        w1 = (wr.normal(size=(n_layers, c_max, cb)) / np.sqrt(c_max)).astype(np.float32)
        for l in range(n_layers):              # zero beyond each layer's input channels
            c_in = c0 + l * growth
            a1[l, c_in:] = b1[l, c_in:] = w1[l, c_in:] = 0
        a2 = wr.uniform(0.8, 1.2, (n_layers, cb)).astype(np.float32)
        b2 = (wr.normal(size=(n_layers, cb)) * 0.1).astype(np.float32)
        w2 = (wr.normal(size=(n_layers, 9, cb, growth)) / np.sqrt(9 * cb)).astype(np.float32)
        arrays = [torch.as_tensor(a, device=dev) for a in (a1, b1)] + \
            [torch.as_tensor(w1, device=dev).to(torch.bfloat16)] + \
            [torch.as_tensor(a, device=dev) for a in (a2, b2)] + \
            [torch.as_tensor(w2, device=dev).to(torch.bfloat16)]
        x = torch.as_tensor(wr.normal(size=(CHUNK, side, side, c0)).astype(np.float32),
                            device=dev).to(torch.bfloat16)
        route = dense.route(c0, growth, cb)
        before = dense.launches
        got = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth).float()
        want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=growth).float()
        torch.cuda.synchronize()
        per_layer = 1 if route == "wgmma" else 2
        if dense.launches - before != per_layer * n_layers:
            raise AssertionError(f"dense block growth {growth}: {dense.launches - before} "
                                 f"launches for {n_layers} layers on the {route} route")
        err = float((got - want).abs().max().item())
        corr = float(np.corrcoef(got.cpu().numpy().ravel()[::7],
                                 want.cpu().numpy().ravel()[::7])[0, 1])
        if not (torch.allclose(got, want, rtol=3e-2, atol=3e-2) and corr > 0.999
                and got.shape[-1] == c_max):
            raise AssertionError(f"dense block growth {growth}, Cb {cb}: kernel differs "
                                 f"from plain (max abs {err}, corr {corr})")
        ms, _ = cuda_ms(torch, lambda: dense.fused_dense_block(
            x, *arrays, c_in0=c0, growth=growth), iters=5)
        log(f"dense block {side}x{side}, {c0} -> {c_max}, growth {growth}, Cb {cb} "
            f"({route} route, {per_layer} launches a layer): max abs err {err:.4g}, corr "
            f"{corr:.6f}; kernel {ms:.4f} ms per call (events)")
    return res


def phase_densenet(torch, slides, positions, masks, port, variables, card):
    """Both DenseNet-121 routes at full width. Returns the fused route's
    kernel launches and the model directory's meta."""
    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr, dense = port
    log("== phase 6: DenseNet-121 at full width (TF32 off for the f32 route)")
    dev = slides.device
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    meta = {"model": "GridNetHex+DenseNet121", "classes": classes,
            "patch_px": PATCH, "patch_chunk": CHUNK}
    f_vars = {c: variables[c]["patch_classifier"] for c in ("params", "batch_stats")}
    n_spots = [int(m.sum()) for m in masks]

    # 1. the model-directory route: f32 module
    reg = modeldir.image_registrar_from_meta(meta, classes, variables, device=dev)
    dense.launches = 0
    labels0 = reg(slides[0], positions[0])
    labels_f32 = reg.register_batch(slides, positions)
    logits_f32 = [reg.register_logits(slides[i], positions[i])[0]
                  for i in range(N_SLIDES)]
    torch.cuda.synchronize()
    if dense.launches:
        raise AssertionError("the f32 route launched the dense-block kernel")
    for got, mask in [(labels0 > 0, masks[0])] + [
            (labels_f32[i] > 0, masks[i]) for i in range(N_SLIDES)]:
        if not np.array_equal(got, mask > 0):
            raise AssertionError("f32 route: foreground differs from the tissue mask")
    if not all(np.isfinite(x).all() for x in logits_f32) or labels_f32.max() > N_CLASSES:
        raise AssertionError("f32 route: non-finite logits or labels out of range")
    serving.label_parity_report(labels_f32[0], labels0, logits_f32[0])
    # a direct GridNetHex(DenseNet-121) forward on slide 1's patch grid
    model = from_jax.load_gridnet(models.GridNetHex(
        models.densenet121(num_classes=N_CLASSES), n_classes=N_CLASSES,
        f_dim=N_CLASSES), variables).to(dev).eval()
    model.patch_chunk = CHUNK
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(positions[1])
    crops = gather.gather_patches_plain(
        slides[1], torch.as_tensor(y_px - PATCH // 2, device=dev),
        torch.as_tensor(x_px - PATCH // 2, device=dev), PATCH)
    grid = torch.zeros((78, 64, PATCH, PATCH, 3), device=dev)
    grid[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        crops.float() / 255.0
    with torch.inference_mode():
        ref = model(grid[None])[0].cpu().numpy()
    ref_err = float(np.abs(ref - logits_f32[1]).max())
    if not ref_err <= 1e-3:
        raise AssertionError(f"f32 route: register_logits differs from the "
                             f"GridNetHex forward by {ref_err}")
    log(f"f32 route: foreground equals every mask; register_logits vs GridNetHex "
        f"forward: max abs err {ref_err:.3g}")
    del grid

    # 2. the fused route: bf16 blocks through the kernel, the same corrector
    fused = serving.SlideRegistrar(
        dense.build_densenet_fused_infer(f_vars, device=dev), reg.kernels, reg.biases,
        reg.relu_flags, patch_size=PATCH, normalize=None, patch_chunk=CHUNK,
        device=dev)
    layers = []          # layers of each dense-block call the fused f makes
    block_fn = dense.fused_dense_block

    def counted_block(x, A1, *args, **kwargs):
        layers.append(int(A1.shape[0]))
        return block_fn(x, A1, *args, **kwargs)

    dense.fused_dense_block = counted_block
    try:
        gather.launches = 0
        dense.launches = 0
        for k in corr.launches:
            corr.launches[k] = 0
        labels_bf16 = fused.register_batch(slides, positions)
        torch.cuda.synchronize()
    finally:
        dense.fused_dense_block = block_fn
    launches = {"gather_patches": gather.launches, **corr.launches,
                "fused_dense_block": dense.launches}
    log(f"fused-route kernel launches: {launches} ({len(layers)} dense-block calls, "
        f"{sum(layers)} layers)")
    for name in ("gather_patches", "fused_hex_corrector_labels", "fused_dense_block"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the fused route")
    if launches["fused_dense_block"] != sum(layers):
        raise AssertionError(f"{launches['fused_dense_block']} dense-block launches for "
                             f"{sum(layers)} layers: not one launch per layer")
    flips = 0
    for i in range(N_SLIDES):
        if not np.array_equal(labels_bf16[i] > 0, masks[i] > 0):
            raise AssertionError("fused route: foreground differs from the tissue mask")
        flips += serving.label_parity_report(labels_f32[i], labels_bf16[i],
                                             logits_f32[i], rel_tol=BF16_REL_TOL)
    log(f"fused route vs f32 route: labels equal up to {flips} near-tie flips of "
        f"{sum(n_spots)} spots (rel_tol {BF16_REL_TOL})")

    # 3. one 624-patch chunk: fused f against the f32 module
    chunk = crops[:CHUNK].float() / 255.0
    with torch.inference_mode():
        want = reg.f_apply(chunk)
        got = fused.f_apply(chunk)
    scale = float(want.abs().max().item())
    rel = float((got - want).abs().max().item()) / scale
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean().item())
    if not (torch.isfinite(got).all() and rel <= BF16_REL_TOL):
        raise AssertionError(f"fused f differs from the f32 module by {rel:.4g} of "
                             f"the largest logit")
    log(f"fused f vs f32 module on {CHUNK} patches of slide 1: max abs diff "
        f"{rel:.4g} of the largest logit ({scale:.4g}), argmax agreement "
        f"{agree * 100:.2f} %")
    del crops, chunk

    # 4. register_batch of both routes in turns: k p p k k p p k
    times = {"fused": [], "f32": []}
    for name in ("fused", "f32", "f32", "fused") * 2:
        r = fused if name == "fused" else reg
        t0 = time.perf_counter()
        r.register_batch(slides, positions)
        times[name].append(time.perf_counter() - t0)
    t, t32 = (float(np.median(times[k])) for k in ("fused", "f32"))
    log(f"DenseNet-121 register_batch of {N_SLIDES} slides ({sum(n_spots)} spots), "
        f"median of 4: fused bf16 route {t * 1e3 / N_SLIDES:.2f} ms/slide, "
        f"{sum(n_spots) / t:.0f} spots/s (runs {[round(x * 1e3, 2) for x in times['fused']]} "
        f"ms); f32 route without TF32 {t32 * 1e3 / N_SLIDES:.2f} ms/slide, "
        f"{sum(n_spots) / t32:.0f} spots/s (runs "
        f"{[round(x * 1e3, 2) for x in times['f32']]} ms) [{card}]")
    profile_batch(torch, fused, slides, positions,
                  ("gather_patches", "fused_dense_block", "fused_hex_corrector_labels"))
    return launches, meta


def phase_resize(torch, slides, positions, masks, port, meta, variables):
    """The resized-window path on slide 0: its kernels' launches, the gather
    at the window size, the resize, and the labels and logits against the
    plain-version registrar on the same f."""
    from gridnext_tpu_torch import pipeline

    modeldir, serving, gather, corr = port[4], port[6], port[7], port[8]
    log(f"== phase 7: window resize (window_px = {WINDOW}, patch_px = {PATCH}, "
        f"DenseNet-121 f32 model directory, TF32 off)")
    dev = slides.device
    reg = modeldir.image_registrar_from_meta(dict(meta, window_px=WINDOW),
                                             meta["classes"], variables, device=dev)
    if (reg.window_size, reg.patch_size) != (WINDOW, PATCH):
        raise AssertionError(f"window {reg.window_size}, patch {reg.patch_size}")
    gather.launches = 0
    for k in corr.launches:
        corr.launches[k] = 0
    labels = reg(slides[0], positions[0])
    logits, fg = reg.register_logits(slides[0], positions[0])
    torch.cuda.synchronize()
    launches = {"gather_patches": gather.launches, **corr.launches}
    log(f"resized-window kernel launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the resized-window path")
    for got in (labels > 0, fg > 0):
        if not np.array_equal(got, masks[0] > 0):
            raise AssertionError("resized window: foreground differs from the tissue mask")
    if not np.isfinite(logits).all() or logits.shape != (78, 64, N_CLASSES):
        raise AssertionError("resized window: non-finite or misshapen logits")

    # the gather at the window size, bit-exact on the registrar's own corners
    _, _, _, y_px, x_px = reg._prepared_inputs(slides[0], positions[0], 0)
    args = (slides, y_px - WINDOW // 2, x_px - WINDOW // 2, WINDOW,
            torch.zeros_like(y_px))
    got, want = gather.gather_patches(*args), gather.gather_patches_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        err = int((got.int() - want.int()).abs().max().item())
        raise AssertionError(f"gather at window {WINDOW} differs from plain (max "
                             f"abs {err})")
    # the resize on the card against a float64 product on the host with the
    # same weights; a requantisation at .5 may round either way
    crops = want[:128]
    resized = pipeline.resize_patches(crops, PATCH).cpu()
    wm = torch.from_numpy(pipeline.cubic_resize_weights(WINDOW, PATCH)).double()
    ref = torch.einsum("nhwc,hp,wq->npqc", crops.cpu().double(), wm, wm)
    ref = torch.clamp(torch.round(ref), 0, 255)
    diff = (resized.double() - ref).abs()
    if resized.dtype != torch.uint8 or not float(diff.max()) <= 1:
        raise AssertionError(f"resize on the card differs from the float64 product "
                             f"by {float(diff.max())}")
    del got, want, crops

    # the same f and corrector with the plain gather and corrector
    plain = plain_registrar_class(serving, gather, corr)(
        reg.f_apply, reg.kernels, reg.biases, reg.relu_flags, patch_size=PATCH,
        window_size=WINDOW, normalize=reg.normalize, patch_chunk=reg.patch_chunk,
        device=dev)
    plain_logits, _ = plain.register_logits(slides[0], positions[0])
    logit_err = float(np.abs(logits - plain_logits).max())
    if not logit_err <= 1e-3:
        raise AssertionError(f"resized window: register_logits differs from the "
                             f"plain registrar by {logit_err}")
    flips = serving.label_parity_report(plain(slides[0], positions[0]), labels,
                                        plain_logits)
    log(f"resized window on slide 0: {launches} launches, foreground equals the "
        f"mask ({int((labels > 0).sum())} spots); gather at {WINDOW} px bit-exact "
        f"({len(y_px)} crops); resize of 128 crops vs float64: "
        f"{int((diff > 0).sum())} of {diff.numel()} values off by 1; vs the plain "
        f"registrar: logits max abs err {logit_err:.3g}, {flips} near-tie flips")


def phase_favor(torch, favor_cuda, dev):
    """The FAVOR kernel against its plain version at scBERT's shape, at a
    ragged N with m not a multiple of 32 and at head widths 48 and 128;
    timed at scBERT's shape."""
    from gridnext_tpu_torch.models.performer import default_nb_features
    from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

    log("== phase 8: FAVOR kernel (TF32 off)")
    name = "fused_generalized_linear_attention"
    m_full = default_nb_features(MM_DIM_HEAD)
    rng = np.random.default_rng(SEED + 5)
    res = None
    # scBERT's shape, a ragged one, and head widths 48 (a compiled instance)
    # and 128 (the general kernels) that the wrapper once refused
    for b, h, n, d, m in ((COUNT_CHUNK, MM_HEADS, MM_VOCAB + 1, MM_DIM_HEAD, m_full),
                          (3, 7, 1000, MM_DIM_HEAD, 37),
                          (2, 10, 4000, 48, default_nb_features(48)),
                          (2, 10, 4000, 128, default_nb_features(128))):
        q, k, v = (torch.as_tensor(rng.standard_normal((b, h, n, d), dtype=np.float32),
                                   device=dev) for _ in range(3))
        proj = orthogonal_gaussian_matrix(
            m, d, generator=torch.Generator().manual_seed(SEED + m)).to(dev)

        def kernel():
            return favor_cuda.fused_generalized_linear_attention(q, k, v, proj)

        def plain():
            return favor_cuda.favor_attention_plain(q, k, v, proj)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max().item())
        worst = float((diff / (FAVOR_ATOL + FAVOR_RTOL * want.abs())).max().item())
        if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
            raise AssertionError(f"FAVOR kernel at {(b, h, n, d, m)} differs from plain: "
                                 f"max abs {err}, {worst:.3g} x the tolerance")
        log(f"favor B={b} H={h} N={n} d={d} m={m}: max abs err {err:.3g}, worst "
            f"|diff| / (atol + rtol |plain|) {worst:.3g} (rtol {FAVOR_RTOL}, atol "
            f"{FAVOR_ATOL})")
        del got, want, diff
        if res is None:        # scBERT's shape: the kernels line's numbers
            ms, host_ms = cuda_ms(torch, kernel, iters=20)
            dev_ms, parts = kernel_line(device_ms(torch, kernel, 10, KERNEL_SYMBOLS[name]))
            plain_ms, _ = cuda_ms(torch, plain, iters=5, warmup=1)
            flops = 4 * 2 * b * h * n * d * m + 2 * b * h * n * m
            nbytes = 4 * (4 * b * h * n * d + m * d)
            # the kernel's products run as three TF32 products each (split TF32)
            t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
            t_f32 = flops / FP32_FLOPS_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            res = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            log(f"favor B={b} H={h} N={n} d={d} m={m}: kernel {ms:.4f} ms per call "
                f"(events; host issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} "
                f"ms ({parts}), plain {plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
                f"({flops / 1e9:.1f} GFLOP: split TF32 {t_ops:.4f} ms, f32 FMA "
                f"{t_f32:.4f} ms; {nbytes / 1e9:.3f} GB -> {t_bytes:.4f} ms)")
        del q, k, v
    return res


@contextlib.contextmanager
def plain_favor(performer, favor_cuda):
    """FastAttention through the FAVOR kernel's plain version, for the
    plain-version route of phase 9."""
    kernel = performer.fused_generalized_linear_attention
    performer.fused_generalized_linear_attention = favor_cuda.favor_attention_plain
    try:
        yield
    finally:
        performer.fused_generalized_linear_attention = kernel


def count_f_routes(torch, count_f, chunk, depth: int):
    """An scBERT count f's logits on ``chunk`` through the FAVOR kernel and
    through its plain version, without gradients: ``(kernel, plain)``.
    Fails unless the kernel route launched FAVOR ``depth`` times and the
    plain route not at all."""
    from gridnext_tpu_torch.models import performer
    from gridnext_tpu_torch.ops import favor_cuda

    with torch.no_grad():
        before = favor_cuda.launches
        got = count_f(chunk)
        with plain_favor(performer, favor_cuda):
            want = count_f(chunk)
    if favor_cuda.launches != before + depth:
        raise AssertionError(f"the count f launched FAVOR {favor_cuda.launches - before} "
                             f"times over the two routes, not {depth}")
    return got, want


def device_total_ms(prof) -> float:
    """Device time of every CUDA kernel in a torch.profiler trace, ms (the
    ``ProfilerStep*`` rows of a scheduled trace span the steps' kernels and
    are left out)."""
    from torch.autograd import DeviceType

    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not evt.key.startswith("ProfilerStep"):
            us = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if us is None else us
    return total / 1e3


def phase_mm(torch, slides, positions, masks, port, card):
    """One multimodal request at full width: an scBERT + DenseNet-121 model
    directory registers slide 0. Returns the FAVOR kernel's launches and the
    request: its meta, variables, raw count grid and ms (phases 13 and 14
    build their depth-cut models from them)."""
    from torch.profiler import ProfilerActivity, profile

    from gridnext_tpu_torch.models import performer
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names
    from gridnext_tpu_torch.ops import favor_cuda

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log(f"== phase 9: multimodal registration at full width: scBERT over {MM_VOCAB} "
        f"genes (dim {MM_DIM}, depth {MM_DEPTH}, heads {MM_HEADS}, dim_head "
        f"{MM_DIM_HEAD}, count_chunk {COUNT_CHUNK}) + DenseNet-121, f32, TF32 off")
    dev = slides.device
    h_st, w_st = geometry.VISIUM_H_ST, geometry.VISIUM_W_ST
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    meta = {"model": "GridNetHexMM", "classes": classes, "patch_px": PATCH,
            "window_px": None, "patch_chunk": CHUNK, "count_chunk": COUNT_CHUNK,
            "log1p": False, "count_f": "scbert", "scbert_vocab": MM_VOCAB,
            "scbert_dim": MM_DIM, "scbert_depth": MM_DEPTH, "scbert_heads": MM_HEADS,
            "scbert_dim_head": MM_DIM_HEAD, "scbert_features": None, "hd_binning": None,
            "grid_dims": None, "image_f": "densenet", "dense_ingest": False}
    template = models.GridNetHexMM(
        models.densenet121(num_classes=N_CLASSES),
        models.scBERT(n_genes=MM_VOCAB, dim=MM_DIM, depth=MM_DEPTH, heads=MM_HEADS,
                      dim_head=MM_DIM_HEAD, n_classes=N_CLASSES,
                      generalized_attention=True), N_CLASSES)
    variables = random_variables(models, from_jax, seed=SEED + 6, model=template)
    del template
    model = modeldir.mm_model_from_meta(meta, classes, variables, device=dev)

    # the request: slide 0's image grid (/255 crops at its spots, zeros
    # elsewhere) and a raw count grid over the gene2vec genes
    mask = masks[0] > 0
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(positions[0])
    oy_t, ox_t = torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)
    crops = gather.gather_patches_plain(
        slides[0], torch.as_tensor(y_px - PATCH // 2, device=dev),
        torch.as_tensor(x_px - PATCH // 2, device=dev), PATCH)
    x_image = torch.zeros((h_st, w_st, PATCH, PATCH, 3), device=dev)
    x_image[oy_t, ox_t] = crops.float() / 255.0
    del crops
    genes = load_gene2vec_names()[:MM_VOCAB]
    raw = np.zeros((h_st, w_st, len(genes)), np.float32)
    raw[mask] = np.random.default_rng(SEED + 7).poisson(COUNT_RATE,
                                                        (int(mask.sum()), len(genes)))
    transform = modeldir.scbert_transform(genes, MM_VOCAB)
    t0 = time.perf_counter()
    x_count = transform(raw)
    t_transform = time.perf_counter() - t0

    # the kernel route: the entry point, its FAVOR launches counted
    favor_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = serving.register_mm_grid(model, x_image, raw, transform, device=dev)
    t_kernel = time.perf_counter() - t0
    launches = favor_cuda.launches
    want_launches = -(-h_st * w_st // COUNT_CHUNK) * MM_DEPTH
    log(f"multimodal register_mm_grid: {launches} FAVOR launches "
        f"({want_launches} expected: {h_st * w_st} cells / {COUNT_CHUNK} x {MM_DEPTH} "
        f"layers)")
    if launches != want_launches:
        raise AssertionError(f"FAVOR launched {launches} times, not {want_launches}")
    if labels.shape != (h_st, w_st) or not np.array_equal(labels > 0, mask):
        raise AssertionError("multimodal: foreground differs from the tissue mask")
    if labels.max() > N_CLASSES:
        raise AssertionError(f"multimodal: label {labels.max()} out of range")

    # the plain-version route: the same model, FastAttention through the
    # FAVOR kernel's plain version
    xc = torch.as_tensor(x_count, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_favor(performer, favor_cuda), torch.no_grad():
        plain_logits = model((x_image[None], xc[None]))[0].cpu().numpy()
    t_plain = time.perf_counter() - t0
    if favor_cuda.launches != launches:
        raise AssertionError("the plain-version route launched the FAVOR kernel")
    if not np.isfinite(plain_logits).all():
        raise AssertionError("multimodal: non-finite plain-route logits")
    flips = serving.label_parity_report(
        np.where(mask, plain_logits.argmax(-1) + 1, 0), labels, plain_logits)

    # the count f's logits on three 8-cell chunks of the tissue
    cells = xc[oy_t, ox_t]
    count_err, count_scale, wants = 0.0, 0.0, []
    for start in (0, len(oy) // 2, len(oy) - COUNT_CHUNK):
        got, want = count_f_routes(torch, model.count_classifier,
                                   cells[start:start + COUNT_CHUNK], MM_DEPTH)
        count_err = max(count_err, float((got - want).abs().max().item()))
        count_scale = max(count_scale, float(want.abs().max().item()))
        wants.append(want)
    if not count_err <= 1e-3:
        raise AssertionError(f"count f logits differ from the plain route by {count_err}")
    wants = torch.cat(wants)
    spread = float((wants.amax(0) - wants.amin(0)).max().item())
    if not spread > 1e-2:
        raise AssertionError(f"the count f gives every cell the same logits (spread "
                             f"{spread}): the comparison would not see the attention")
    n_spots = int(mask.sum())
    hist = np.bincount(labels[mask], minlength=N_CLASSES + 1)[1:].tolist()
    log(f"multimodal vs the plain-version route: labels equal up to {flips} near-tie "
        f"flips of {n_spots} spots (spots per class {hist}); count-f logits on 3 "
        f"chunks max abs err {count_err:.3g} (<= 1e-3; largest logit {count_scale:.3g}, "
        f"spread across the {len(wants)} cells {spread:.3g})")
    log(f"multimodal registration of slide 0 ({n_spots} spots, {h_st * w_st} cells through "
        f"each f), one request: register_mm_grid {t_kernel * 1e3:.2f} ms/slide, "
        f"{n_spots / t_kernel:.1f} spots/s (host count transform {t_transform * 1e3:.2f} ms "
        f"of it); plain-version route's forward {t_plain * 1e3:.2f} ms/slide [{card}]")

    # where the device time of a count chunk goes: two chunks traced after an
    # untraced warm-up step (a trace can lose its first kernel events)
    chunk = cells[:COUNT_CHUNK]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  schedule=schedule) as prof:
        for _ in range(3):
            model.count_classifier(chunk)
            torch.cuda.synchronize()
            prof.step()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    total = device_total_ms(prof) / 2
    traced = traced_kernels(prof, KERNEL_SYMBOLS["fused_generalized_linear_attention"], 2)
    fav_ms, parts = kernel_line(traced)
    log(f"count-chunk trace ({COUNT_CHUNK} cells, mean of 2 chunks): device {total:.4f} ms, "
        f"FAVOR kernels {fav_ms:.4f} ms ({fav_ms / total * 100:.1f} %; {parts})")
    if any(n != MM_DEPTH for n, _ in traced.values()):
        raise AssertionError(f"the count-chunk trace holds {traced}, not {MM_DEPTH} "
                             f"launches of each FAVOR kernel per chunk")
    return launches, {"meta": meta, "variables": variables, "raw": raw,
                      "ms": t_kernel * 1e3}


def tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def loupe_grid(path, shape, classes):
    """The label grid a Loupe CSV of the bench lattice names (spot ``i`` of
    the positions file is cell ``divmod(i, 64)``) and its row count."""
    grid = np.zeros(shape, np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if rows[0] != ["Barcode", "AARs"]:
        raise AssertionError(f"Loupe CSV header {rows[0]}")
    for barcode, annot in rows[1:]:
        y, x = divmod(int(barcode.split("BC")[1].split("-")[0]), shape[1])
        grid[y, x] = classes.index(annot) + 1
    return grid, len(rows) - 1


def merged(spans):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def staging_overlap(prof, path) -> dict:
    """From a torch.profiler trace (exported to ``path`` as a Chrome trace):
    the pinned host-to-card copies' count and device ms, the share of that
    time during which a kernel ran, and the device's busy ms (the union of
    kernels and copies)."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    copies, kernels = [], []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        name, cat = str(e.get("name", "")), str(e.get("cat", ""))
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if "HtoD" in name and "Pinned" in name:
            copies.append(span)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append(span)
    busy = merged(kernels)
    copy_us = sum(b - a for a, b in copies)
    hidden_us = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in copies for ka, kb in busy)
    return {"h2d_copies": len(copies), "h2d_ms": copy_us / 1e3,
            "h2d_under_kernels": hidden_us / copy_us if copy_us else None,
            "device_busy_ms": sum(b - a for a, b in merged(copies + kernels)) / 1e3}


def device_ms_by_range(path, names) -> dict:
    """From a Chrome trace at ``path``: each device event's ms, summed by the
    innermost of the ``record_function`` ranges ``names`` (host spans, on
    any thread) that its launch fell in; ``"other"`` for the rest."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, launched, device = [], {}, []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        cat, args = str(e.get("cat", "")), e.get("args") or {}
        if cat == "user_annotation" and e.get("name") in names:
            spans.append((float(e["dur"]), float(e["ts"]), e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launched[args["correlation"]] = float(e["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((args.get("correlation"), float(e["dur"])))
    spans.sort()                                   # the innermost (shortest) first
    out = dict.fromkeys((*names, "other"), 0.0)
    for corr, dur in device:
        t = launched.get(corr)
        name = next((n for d, a, n in spans if t is not None and a <= t <= a + d), "other")
        out[name] += dur / 1e3
    return out


def phase_register_slides(torch, slides, port, card, tmp, batch4):
    """The ``register`` command's path at full width: a model directory on
    disk, six slide files through ``register_slides``, four through the CLI.
    Returns the Spaceranger dirs and tissue masks it wrote, and the model
    directory, the slide files of slides 0-3, the register command's CSVs
    and the registrar (phase 18 serves them)."""
    from gridnext_tpu_torch import cli, ingest

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log("== phase 10: register_slides and the register command at full width "
        "(TpuPatchClassifier model directory on disk, TF32 off)")
    dev = slides.device
    meta = {"model": "GridNetHex+TpuPatchClassifier",
            "classes": [f"Class_{i + 1}" for i in range(N_CLASSES)],
            "tpu_f": {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"},
            "patch_px": PATCH, "patch_chunk": CHUNK}
    variables = random_variables(models, from_jax)      # phase 4's weights
    model_dir = os.path.join(tmp, "model")
    from_jax.save_model_dir(model_dir, meta, variables)
    meta2, classes, loaded = from_jax.load_model_dir(model_dir)
    want = dict(tree_leaves(variables))
    got = dict(tree_leaves(loaded))
    if meta2 != meta or set(got) != set(want) or not all(
            np.asarray(got[k]).dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want):
        raise AssertionError("the model directory did not read back bit-equal")
    log(f"model directory written and read back bit-equal: {len(want)} arrays, "
        f"{os.path.getsize(os.path.join(model_dir, 'g_state.msgpack')) / 1e6:.1f} MB")

    dirs_masks = [write_spaceranger_dir(tmp, geometry, f, i)
                  for i, f in enumerate(TISSUE_FRACTIONS)]
    # A A B A A B: A is a full slide (0-3), B slide 0 or 1 cut to B_ROWS rows
    order = [("A", 0), ("A", 1), ("B", 0), ("A", 2), ("A", 3), ("B", 1)]
    files, dirs, masks, refs = [], [], [], []
    t0 = time.perf_counter()
    for k, (kind, i) in enumerate(order):
        wsi = slides[i] if kind == "A" else slides[i][:B_ROWS]
        files.append(os.path.join(tmp, f"slide{k}_{kind}{i}.npy"))
        np.save(files[-1], wsi.cpu().numpy())
        dirs.append(dirs_masks[i][0])
        masks.append(dirs_masks[i][1])
        refs.append(wsi)
    log(f"wrote {len(files)} slides as .npy in the order A A B A A B "
        f"({sum(os.path.getsize(f) for f in files) / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s); the card has no PIL, so they decode "
        f"with np.load")
    reg = modeldir.image_registrar_from_meta(meta2, classes, loaded, device=dev)

    # the serving loop, its counts set to 0 just before and read just after
    batch = 4
    source = ingest.SlideSource(files, dirs, prefetch=batch + 1, decode=np.load,
                                device=dev)
    stats = {}
    torch.cuda.synchronize()
    gather.launches = 0
    for k in corr.launches:
        corr.launches[k] = 0
    t0 = time.perf_counter()
    results = list(serving.register_slides(reg, files, dirs, slide_batch=batch,
                                           source=source, stats=stats))
    wall = time.perf_counter() - t0
    launches = {"gather_patches": gather.launches, **corr.launches}
    log(f"register_slides kernel launches: {launches}")
    for name in ("gather_patches", "fused_hex_corrector_labels"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by register_slides")
    # the cap flushes A A _ A (three slides), then B B and the last A alone
    got_order = [i for i, _, _ in results]
    if got_order != [0, 1, 3, 2, 5, 4] or stats != {"batched": 5}:
        raise AssertionError(f"register_slides yielded {got_order}, stats {stats} "
                             f"(want [0, 1, 3, 2, 5, 4] and 5 slides batched)")

    flips, logits = 0, {}
    for i, labels, pos in results:
        lg, fg = reg.register_logits(refs[i], pos)
        logits[i] = lg
        flips += serving.label_parity_report(reg(refs[i], pos), labels, lg)
        if not (np.array_equal(labels > 0, masks[i] > 0) and np.array_equal(fg > 0, masks[i] > 0)):
            raise AssertionError(f"slide {i}: foreground differs from the tissue mask")
    t = source.timer.summary()
    n = len(files)
    per = {k: v * 1e3 / n for k, v in t.items()}
    log(f"register_slides over {n} slides (A A B A A B, slide_batch {batch}): yield order "
        f"{got_order}, stats {stats}; labels equal reg(slide) up to {flips} near-tie flips, "
        f"foreground equal to the masks")
    log(f"register_slides wall {wall * 1e3 / n:.2f} ms/slide (host clock, first next() "
        f"to the last labels on the host); stage ms/slide {json.dumps(per)}; throughput "
        f"{json.dumps(source.throughput())}; max(decode, register) "
        f"{max(per['decode'], per['register']):.2f}, sum "
        f"{per['decode'] + per['register']:.2f} ms/slide; decode thread (decode + pin + "
        f"stage + positions) {per['decode'] + per.get('pin', 0) + per['stage'] + per['positions']:.2f} ms/slide; "
        f"phase 4's register_batch {batch4['ms_per_slide']:.2f} ms/slide [{card}]")

    # the same loop again: the first pass allocated its pinned buffers, this
    # one takes them from PyTorch's pinned-memory cache
    warm = ingest.SlideSource(files, dirs, prefetch=batch + 1, decode=np.load, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm_order = [i for i, _, _ in serving.register_slides(reg, files, dirs, slide_batch=batch,
                                                           source=warm)]
    warm_wall = time.perf_counter() - t0
    if warm_order != got_order:
        raise AssertionError(f"the second pass yielded {warm_order}")
    wper = {k: v * 1e3 / n for k, v in warm.timer.summary().items()}
    log(f"register_slides again (pinned and card memory from the caches): wall "
        f"{warm_wall * 1e3 / n:.2f} ms/slide; stage ms/slide {json.dumps(wper)}; decode "
        f"thread (decode + pin + stage + positions) "
        f"{wper['decode'] + wper.get('pin', 0) + wper['stage'] + wper['positions']:.2f} "
        f"ms/slide against register {wper['register']:.2f} [{card}]")

    # a third pass under torch.profiler: do the copies to the card run while
    # the registration's kernels run?
    from torch.profiler import ProfilerActivity, profile

    traced = ingest.SlideSource(files, dirs, prefetch=batch + 1, decode=np.load, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in serving.register_slides(reg, files, dirs, slide_batch=batch, source=traced):
            pass
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    ov = staging_overlap(prof, os.path.join(tmp, "register_slides_trace.json"))
    idle = (1 - ov["device_busy_ms"] / (traced_wall * 1e3)) if traced_wall else None
    log(f"register_slides traced: {json.dumps(ov)}; wall {traced_wall * 1e3:.1f} ms, device "
        f"idle share {idle if idle is None else round(idle, 4)} [{card}]")
    # the copies and the CUDA runtime calls of the loop (host ms), e.g. the
    # allocations and synchronisations that staging may wait on
    rows = [(e.key, e.count, e.cpu_time_total / 1e3,
             getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages()
            if e.key.startswith(("cuda", "Memcpy")) or "emcpy" in e.key]
    for key, count, cpu, devt in sorted(rows, key=lambda r: -r[2])[:8]:
        log(f"  traced {key[:48]:48s} x{count:<6d} host {cpu:9.3f} ms  device {devt:9.3f} ms")

    # the register command over slides 0-3, decode swapped for np.load
    out = os.path.join(tmp, "loupe")
    a_files = [files[k] for k, (kind, _) in enumerate(order) if kind == "A"]
    a_logits = [logits[k] for k, (kind, _) in enumerate(order) if kind == "A"]
    decode = ingest.decode_slide
    ingest.decode_slide = np.load
    try:
        t0 = time.perf_counter()
        cli.main(["register", "--model", model_dir, "--images", *a_files,
                  "--spaceranger", *[d for d, _ in dirs_masks], "--out", out,
                  "--device", str(dev)])
        t_cli = time.perf_counter() - t0
    finally:
        ingest.decode_slide = decode
    cli_flips = 0
    for i, (d, mask) in enumerate(dirs_masks):
        grid, n_rows = loupe_grid(os.path.join(out, f"slide{i}_loupe.csv"), mask.shape,
                                  classes)
        if n_rows != int(mask.sum()):
            raise AssertionError(f"CLI CSV of slide {i}: {n_rows} rows, {mask.sum()} spots")
        cli_flips += serving.label_parity_report(batch4["labels_b"][i], grid, a_logits[i])
    log(f"register command over slides 0-3: {t_cli:.2f} s with the model load; the CSVs "
        f"name phase 4's register_batch labels up to {cli_flips} near-tie flips")
    return dirs_masks, {"model_dir": model_dir, "files": a_files, "csv_dir": out,
                        "classes": classes, "registrar": reg}


def write_unified_cache(path, genes, columns, counts):
    """A unified count cache in the single-member framing (one gzip stream,
    level 1, as pandas or ``gzip.open`` write it, not the ``GX`` member
    chain the package's ``prepare`` writes): a ``Gene`` header over the
    spot columns, a row of integer counts per gene."""
    import gzip

    from gridnext_tpu_torch.io.tsv_codec import format_int_rows

    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(("Gene\t" + "\t".join(columns) + "\n").encode())
        fh.write(format_int_rows(np.asarray(counts, np.int64), [g.encode() for g in genes]))


def phase_count(torch, port, card, tmp, dirs_masks, dev):
    """The count route at full width: a unified cache of slide 0 over the
    gene2vec genes and a CountMLP model directory through the register
    command."""
    from gridnext_tpu_torch import cli
    from gridnext_tpu_torch.data import CountGridDataset
    from gridnext_tpu_torch.io.unify import unified_cache_path
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    genes = load_gene2vec_names()[:MM_VOCAB]
    srd, mask = dirs_masks[0]
    log(f"== phase 11: the count route at full width: a GridNetHex+CountMLP model "
        f"directory over {len(genes)} genes, slide 0's unified cache (f32, TF32 off)")
    pos = io.read_positions(srd)
    keep = pos["in_tissue"] == 1
    columns = [f"{c}_{r}" for c, r in zip(pos["array_col"][keep], pos["array_row"][keep])]
    counts = np.random.default_rng(SEED + 8).poisson(COUNT_RATE, (len(genes), len(columns)))
    cfile = unified_cache_path(srd)
    t0 = time.perf_counter()
    write_unified_cache(cfile, genes, columns, counts)
    log(f"unified cache: {len(genes)} genes x {len(columns)} spots, "
        f"{os.path.getsize(cfile) / 1e6:.1f} MB gzip, written in "
        f"{time.perf_counter() - t0:.1f} s")

    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    meta = {"model": "GridNetHex+CountMLP", "classes": classes, "n_genes": len(genes),
            "genes": genes, "log1p": True, "hd_binning": None, "grid_dims": None}
    template = models.GridNetHex(models.CountMLP(len(genes), N_CLASSES), N_CLASSES,
                                 f_dim=N_CLASSES)
    variables = random_variables(models, from_jax, seed=SEED + 9, model=template)
    model_dir = os.path.join(tmp, "model_count")
    from_jax.save_model_dir(model_dir, meta, variables)

    t0 = time.perf_counter()
    x, _ = CountGridDataset([cfile])[0]
    t_read = time.perf_counter() - t0
    out = os.path.join(tmp, "count_loupe.csv")
    t0 = time.perf_counter()
    cli.main(["register", "--model", model_dir, "--spaceranger", srd, "--out", out,
              "--device", str(dev)])
    t_cli = time.perf_counter() - t0

    # the same model on the CPU, f32
    fg = x.sum(-1) > 0
    if not np.array_equal(fg, mask > 0):
        raise AssertionError("count route: the cache's spots differ from the tissue mask")
    xl = np.log1p(x)
    cpu_model = modeldir.grid_model_from_meta(meta, classes, variables, device="cpu")
    with torch.no_grad():
        logits = cpu_model(torch.from_numpy(xl[None]))[0].numpy()
    want = np.where(fg, logits.argmax(-1) + 1, 0)
    spread = float((logits[fg].max(0) - logits[fg].min(0)).max())
    if not spread > 1e-2:
        raise AssertionError(f"count route: every spot has the same logits (spread "
                             f"{spread}): the comparison would not see the counts")
    grid, n_rows = loupe_grid(out, mask.shape, classes)
    if n_rows != int(mask.sum()):
        raise AssertionError(f"count CSV: {n_rows} rows for {mask.sum()} spots")
    flips = serving.label_parity_report(want, grid, logits)

    # the forward's device time on the card
    model = modeldir.grid_model_from_meta(meta, classes, variables, device=dev)
    xd = torch.as_tensor(xl[None], device=dev)
    with torch.no_grad():
        dev_logits = model(xd)[0].cpu().numpy()
        fwd_ms, fwd_host_ms = cuda_ms(torch, lambda: model(xd), 5)
    err = float(np.abs(dev_logits - logits).max())
    if not err <= 1e-3:
        raise AssertionError(f"count route: card logits differ from the CPU's by {err}")
    hist = np.bincount(grid[mask > 0], minlength=N_CLASSES + 1)[1:].tolist()
    log(f"count route: the CSV names the CPU forward's labels up to {flips} near-tie flips "
        f"of {n_rows} spots (spots per class {hist}, logit spread across the tissue "
        f"{spread:.3g}); card logits within {err:.3g} of the "
        f"CPU's; cache read on the host {t_read * 1e3:.1f} ms, GridNetHex+CountMLP forward "
        f"{fwd_ms:.4f} ms on the card (CUDA events, host issue {fwd_host_ms:.4f} ms), "
        f"register command {t_cli * 1e3:.1f} ms with the model load [{card}]")


# -- phase 12: Visium HD ---------------------------------------------------------

HD_BINS = 384                 # 16 um bins over the 6.5 mm capture area (bench.py:644)
HD_PATCH = 32
HD_CHUNK = 1536
HD_BINNING = "square_016um"
HD_PITCH_E, HD_MARGIN_E = 32, 32                        # slide E: an exact tiling
# slide F: 16 um at 0.2737 um/px. The plan's fit sees centers rounded to
# whole pixels and wants them within 0.5 px of its line; at this pitch the
# rounding alone reaches 0.49 px from any origin, and the 0.1 px here keeps
# the fit's largest residual at 0.4918 px (0.4775 on a 24-bin lattice)
HD_PITCH_F, HD_MARGIN_F, HD_WINDOW_F = 58.46, 64.1, 58
HD_JITTER = 3                 # slide J: E's lattice, centers moved by up to 3 px
HD_TISSUE = (0.9, 0.8)        # the tissue ellipse's radii over the lattice's half-axes
HD_ORACLE_TOL = 2e-2          # resampled patches vs the float64 oracle, 0-255 scale
HD_AGREE = 0.9                # resample vs per-bin labels: different pixels by design
# HD slides: 64-px colour blocks (structure at the scale of a bin) and
# pixel noise in [0, 32). The per-bin route's cubic resize of a whole-pixel
# window and the resample of the exact extent read different pixels by
# design; full-range pixel noise (phase 4's slides) separates their labels
# far more than tissue, which has little noise at 0.27 um/px, does
HD_BLOCK, HD_NOISE = 64, 32


def write_hd_dir(root, name, pitch, margin, jitter_seed=None, n=None):
    """A Visium HD Spaceranger directory: the ``square_016um`` positions
    parquet of an n x n lattice (default HD_BINS) of ``pitch`` px bins from
    ``margin``, written by the port's parquet writer (float pixel centers,
    as Spaceranger writes them), with an elliptical tissue mask; centers
    moved by up to HD_JITTER px with ``jitter_seed``. Returns (directory,
    mask)."""
    from gridnext_tpu_torch.io.parquet import write_parquet

    n = HD_BINS if n is None else n
    row = np.repeat(np.arange(n, dtype=np.int64), n)
    col = np.tile(np.arange(n, dtype=np.int64), n)
    y = margin + (row + 0.5) * pitch
    x = margin + (col + 0.5) * pitch
    if jitter_seed is not None:
        rng = np.random.default_rng(jitter_seed)
        y = y + rng.integers(-HD_JITTER, HD_JITTER + 1, y.shape)
        x = x + rng.integers(-HD_JITTER, HD_JITTER + 1, x.shape)
    c = (n - 1) / 2
    r2 = ((row - c) / (c * HD_TISSUE[0])) ** 2 + ((col - c) / (c * HD_TISSUE[1])) ** 2
    in_tissue = (r2 <= 1.0).astype(np.int64)
    srd = os.path.join(root, name)
    spatial = os.path.join(srd, "outs", "binned_outputs", HD_BINNING, "spatial")
    os.makedirs(spatial)
    write_parquet(os.path.join(spatial, "tissue_positions.parquet"), {
        "barcode": [f"s_016um_{r:05d}_{c:05d}-1" for r, c in zip(row, col)],
        "in_tissue": in_tissue, "array_row": row, "array_col": col,
        "pxl_row_in_fullres": y.astype(np.float64), "pxl_col_in_fullres": x.astype(np.float64)})
    return srd, in_tissue.reshape(n, n)


def linear_weights(in_size, out_size, scale, translation):
    """float64 (in_size, out_size) weights of ``jax.image.scale_and_translate
    (method="linear", antialias=True)``: the formula of the JAX package's
    test oracle (``tests/test_serving.py``), dense and independent of the
    port's sparse taps."""
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv - translation * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / ks
    w = np.clip(1 - x, 0, 1)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1e-12, w / np.where(tot == 0, 1, tot), 0)
    ok = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(ok[None, :], w, 0)


def oracle_band(wsi, r, y0, x0, py, px, ex, patch):
    """The float64 oracle of bin row r's exact extents, (ex, P, P, 3): each
    bin's triangle weights over the slide pixels around it (4 px of margin
    hold every nonzero weight; a crop ends only where the slide does)."""
    h, w = wsi.shape[:2]
    ly = max(0, int(np.floor(y0 + r * py)) - 4)
    hy = min(h, int(np.ceil(y0 + (r + 1) * py)) + 4)
    rows = wsi[ly:hy].cpu().numpy().astype(np.float64)
    wy = linear_weights(hy - ly, patch, patch / py, -(y0 + r * py - ly) * patch / py)
    out = np.empty((ex, patch, patch, 3))
    for c in range(ex):
        lx = max(0, int(np.floor(x0 + c * px)) - 4)
        hx = min(w, int(np.ceil(x0 + (c + 1) * px)) + 4)
        wx = linear_weights(hx - lx, patch, patch / px, -(x0 + c * px - lx) * patch / px)
        t = np.tensordot(wy, rows[:, lx:hx], axes=(0, 0))        # (P, cols, 3)
        out[c] = np.tensordot(t, wx, axes=(1, 0)).transpose(0, 2, 1)
    return out


def jax_f32_taps(in_size, out_size, scale, translation):
    """Sparse ``(indices, weights)`` of ``jax.image.scale_and_translate(
    method="linear")`` along one axis as the JAX package computes them
    from float32 scale and translation: sample positions, triangle and
    normalisation in float32, in ``compute_weight_mat``'s order of
    operations (the port's ``pipeline.linear_taps`` does this in
    float64)."""
    f32 = np.float32
    inv = f32(1.0) / f32(scale)
    ks = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(translation) * inv - f32(0.5)
    idx = np.floor(sample - ks).astype(np.int64)[:, None] + np.arange(int(np.ceil(2 * ks)) + 2)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(sample[:, None] - idx.astype(f32)) / ks)
    w = np.where((idx >= 0) & (idx < in_size), w, f32(0.0))
    tot = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[:, None], w, f32(0.0))
    return np.clip(idx, 0, in_size - 1), w.astype(np.float64)


def jax_f32_band(wsi, r, y0, x0, py, px, h_band, ex, patch):
    """Bin row r's (ex, P, P, 3) resampled patches as the JAX package's
    ``_resampled_patches`` computes them: band top, translations and sample
    positions in float32 from float32 ``y0, x0, py, px``; the taps applied
    in float64 on the host. ``wsi``: (H, W, 3), a tensor or numpy."""
    f32 = np.float32
    sy = f32(y0) + f32(r) * f32(py)
    top = int(np.clip(int(np.floor(sy)) - 1, 0, wsi.shape[0] - h_band))
    sc_y, sc_x = f32(patch) / f32(py), f32(patch) / f32(px)
    rows = wsi[top:top + h_band]
    rows = (rows.cpu().numpy() if hasattr(rows, "cpu") else np.asarray(rows)).astype(np.float64)
    iy, wy = jax_f32_taps(h_band, patch, sc_y, -(sy - f32(top)) * sc_y)
    ix, wx = jax_f32_taps(rows.shape[1], ex * patch, sc_x, -f32(x0) * sc_x)
    cols = sum(rows[:, ix[:, t]] * wx[None, :, t, None] for t in range(ix.shape[1]))
    out = sum(cols[iy[:, t]] * wy[:, t, None, None] for t in range(iy.shape[1]))
    return out.reshape(patch, ex, patch, 3).transpose(1, 0, 2, 3)


def resample_logits(torch, reg, wsi, plan):
    """The corrector's (h, w, C) logits on ``register_dense``'s resample
    route: the near-tie judge of its labels."""
    _, y0, x0, py, px, fg, h_band, ey, ex = plan
    with torch.inference_mode():
        feats = torch.cat([reg._apply_f(p) for p in
                           reg._resampled_bands(wsi, y0, x0, py, px, h_band, ey, ex)])
        ry, rx = np.nonzero(fg)
        oy, ox, ext = (torch.as_tensor(a, device=wsi.device) for a in (ry, rx, ry * ex + rx))
        grid, _ = reg._scatter(feats[ext][None], oy[None], ox[None])
        return reg.corrector_apply(grid)[0].float().cpu().numpy()


def calibrated_bns(torch, corrector, grid, variables):
    """``variables`` with ``corrector``'s BatchNorm statistics set to those of
    the feature grid ``grid`` (one pass over every cell), as training
    leaves them: with random weights f's outputs vary little from cell to
    cell, and uncalibrated statistics let one class take nearly every
    cell, so that label checks would see little."""
    with torch.no_grad():
        for bn in corrector.bns:
            bn.momentum = 0.0                      # the running statistics := this batch's
        corrector.train()(grid)
        corrector.eval()
    out = {c: {k: dict(v) for k, v in tree.items()} for c, tree in variables.items()}
    for j, bn in enumerate(corrector.bns):
        out["batch_stats"]["corrector"][f"BatchNorm_{j}"] = {
            "mean": bn.running_mean.cpu().numpy().astype(np.float32),
            "var": bn.running_var.cpu().numpy().astype(np.float32)}
    return out


def calibrated_corrector(torch, modeldir, variables, meta, wsi, positions):
    """:func:`calibrated_bns` of an HD image directory's Cartesian corrector
    on ``wsi``'s per-bin feature grid (f on every in-tissue bin, f(zero
    patch) on background bins)."""
    reg = modeldir.image_registrar_from_meta(meta, meta["classes"], variables,
                                             device=wsi.device)
    with torch.no_grad():
        wsi_d, *spots = reg._prepared_inputs(wsi, positions, 0)
        grid, _ = reg._grid_fg(wsi_d[None], *(t[None] for t in spots))
    return calibrated_bns(torch, reg.corrector_apply, grid, variables)


def host_ms(fn, runs: int = 3) -> tuple:
    """(median ms, the runs) of ``fn`` by the host clock after a warm-up
    call; ``fn`` returns labels on the host, so each run ends synchronised."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), [round(t, 2) for t in times]


def hd_grid_from_csv(path, classes, n=None):
    """The (n, n) label grid (default HD_BINS) a Loupe CSV of an HD lattice
    names (the barcode holds the bin's row and column), and its row count."""
    n = HD_BINS if n is None else n
    grid = np.zeros((n, n), np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if rows[0] != ["Barcode", "AARs"]:
        raise AssertionError(f"Loupe CSV header {rows[0]}")
    for barcode, annot in rows[1:]:
        _, _, r, c = barcode.split("-")[0].split("_")
        grid[int(r), int(c)] = classes.index(annot) + 1
    return grid, len(rows) - 1


def phase_hd(torch, port, card, tmp, dev) -> dict:
    """Visium HD at full width: a GridNet(TpuPatchClassifier) model directory
    over a 384 x 384 lattice of 16 um bins, slides E (exact tiling), F
    (fractional pitch) and J (jittered: per bin). Returns slide E's model
    directory, slide, labels and logits (phase 18 (c) exports them)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gridnext_tpu_torch import cli, ingest

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log(f"== phase 12: Visium HD at full width ({HD_BINS} x {HD_BINS} bins of 16 um, "
        f"{HD_PATCH}-px patches, GridNet(TpuPatchClassifier) with the BatchNorm Cartesian "
        f"corrector, patch_chunk {HD_CHUNK}; TF32 off)")
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    meta = {"model": "GridNet+TpuPatchClassifier", "classes": classes,
            "tpu_f": {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"},
            "patch_px": HD_PATCH, "patch_chunk": HD_CHUNK, "grid_dims": [HD_BINS, HD_BINS],
            "hd_binning": HD_BINNING, "window_px": HD_PITCH_E}
    t0 = time.perf_counter()
    srd_e, mask = write_hd_dir(tmp, "hdE", HD_PITCH_E, HD_MARGIN_E)
    srd_f, _ = write_hd_dir(tmp, "hdF", HD_PITCH_F, HD_MARGIN_F)
    srd_j, _ = write_hd_dir(tmp, "hdJ", HD_PITCH_E, HD_MARGIN_E, jitter_seed=SEED + 11)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos_e, pos_f, pos_j = (io.read_positions(d, HD_BINNING) for d in (srd_e, srd_f, srd_j))
    t_read = (time.perf_counter() - t0) / 3
    n_fg = int(mask.sum())
    side_e = 2 * HD_MARGIN_E + HD_BINS * HD_PITCH_E
    side_f = int(np.ceil(2 * HD_MARGIN_F + HD_BINS * HD_PITCH_F))
    wsi_e = make_slides(torch, 1, side_e, side_e, dev, HD_BLOCK, HD_NOISE)[0]
    wsi_f = make_slides(torch, 1, side_f, side_f, dev, HD_BLOCK, HD_NOISE)[0]
    log(f"positions parquets written in {t_write * 1e3:.0f} ms, read back (io.read_positions) "
        f"in {t_read * 1e3:.1f} ms each ({HD_BINS * HD_BINS} rows, {n_fg} in tissue); "
        f"slide E {side_e} x {side_e} x 3 ({wsi_e.numel() / 1e9:.2f} GB), slide F {side_f} "
        f"x {side_f} x 3 ({wsi_f.numel() / 1e9:.2f} GB)")

    template = models.GridNet(models.TpuPatchClassifier(n_classes=N_CLASSES), N_CLASSES,
                              f_dim=N_CLASSES, use_bn=True)
    variables = calibrated_corrector(torch, modeldir, random_variables(
        models, from_jax, seed=SEED + 10, model=template), meta, wsi_e, pos_e)
    dir_e, dir_f = os.path.join(tmp, "model_hd32"), os.path.join(tmp, "model_hd58")
    from_jax.save_model_dir(dir_e, meta, variables)
    from_jax.save_model_dir(dir_f, {**meta, "window_px": HD_WINDOW_F}, variables)
    meta_e, _, loaded = from_jax.load_model_dir(dir_e)
    want = dict(tree_leaves(variables))
    got = dict(tree_leaves(loaded))
    if meta_e != meta or set(got) != set(want) or not all(
            np.asarray(got[k]).dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want):
        raise AssertionError("the HD model directory did not read back bit-equal")
    reg_e = modeldir.image_registrar_from_meta(meta_e, classes, loaded, device=dev)
    reg_f = modeldir.image_registrar_from_meta(*from_jax.load_model_dir(dir_f), device=dev)

    plan_e = reg_e.dense_plan(wsi_e, pos_e)
    plan_f = reg_f.dense_plan(wsi_f, pos_f)
    plan_j = reg_e.dense_plan(wsi_e, pos_j)
    kinds = [p[0] if p is not None else None for p in (plan_e, plan_f, plan_j)]
    if kinds != ["exact", "resample", None]:
        raise AssertionError(f"plans of E, F, J: {kinds}")
    log(f"plans: E {kinds[0]} (origin {plan_e[1:3]}, extent {plan_e[-2:]}), F {kinds[1]} "
        f"(pitch {plan_f[3]:.4f} x {plan_f[4]:.4f}, origin {plan_f[1]:.3f}, "
        f"{plan_f[2]:.3f}, band {plan_f[6]} rows, extent {plan_f[-2:]}), J none")

    def route(call):
        """``call()`` with the gather's count set to 0 just before and read
        just after."""
        torch.cuda.synchronize()
        gather.launches = 0
        out = call()
        torch.cuda.synchronize()
        return out, gather.launches

    # E: an exact plan registers through the per-bin route (the crops tile
    # the lattice)
    labels_e, n_dense = route(lambda: reg_e.register_dense(wsi_e, pos_e, plan=plan_e))
    per_e, n_per_bin = route(lambda: reg_e(wsi_e, pos_e))
    if n_dense <= 0 or n_per_bin <= 0:
        raise AssertionError(f"gather launches: register_dense {n_dense}, per-bin "
                             f"{n_per_bin} (want more than 0 on each)")
    logits_e, fg_e = reg_e.register_logits(wsi_e, pos_e)
    flips_e = serving.label_parity_report(per_e, labels_e, logits_e)
    for got in (labels_e > 0, per_e > 0, fg_e > 0):
        if not np.array_equal(got, mask > 0):
            raise AssertionError("HD foreground differs from the tissue mask")
    if labels_e.shape != (HD_BINS, HD_BINS) or labels_e.max() > N_CLASSES:
        raise AssertionError(f"HD labels {labels_e.shape}, max {labels_e.max()}")
    hist = np.bincount(labels_e[mask > 0], minlength=N_CLASSES + 1)[1:].tolist()
    spread = float((logits_e[mask > 0].max(0) - logits_e[mask > 0].min(0)).max())
    log(f"E: register_dense labels equal the per-bin route's up to {flips_e} near-tie flips "
        f"of {n_fg} bins (bins per class {hist}, logit spread across the tissue "
        f"{spread:.3g}); gather launches: register_dense {n_dense}, per-bin {n_per_bin}")

    # F: the banded resample against the float64 oracle and the per-bin route
    labels_f, n_dense_f = route(lambda: reg_f.register_dense(wsi_f, pos_f, plan=plan_f))
    per_f, n_per_bin_f = route(lambda: reg_f(wsi_f, pos_f))
    if n_dense_f != 0 or n_per_bin_f <= 0:
        raise AssertionError(f"F gather launches: register_dense {n_dense_f}, per-bin "
                             f"{n_per_bin_f}")
    for got in (labels_f > 0, per_f > 0):
        if not np.array_equal(got, mask > 0):
            raise AssertionError("F foreground differs from the tissue mask")
    agree = float((labels_f[mask > 0] == per_f[mask > 0]).mean())
    if not agree >= HD_AGREE:
        raise AssertionError(f"F: resample and per-bin labels agree on {agree:.4f} of bins")
    _, y0, x0, py, px, fg_f, h_band, ey, ex = plan_f
    bands = sorted({0, ey // 3, 2 * ey // 3, ey - 1})
    picked, r0 = {}, 0
    with torch.inference_mode():
        for chunk in reg_f._resampled_bands(wsi_f, y0, x0, py, px, h_band, ey, ex):
            n = chunk.shape[0] // ex
            for r in bands:
                if r0 <= r < r0 + n:
                    picked[r] = chunk[(r - r0) * ex:(r - r0 + 1) * ex].cpu().numpy()
            r0 += n
    t0 = time.perf_counter()
    oracle = {r: oracle_band(wsi_f, r, y0, x0, py, px, ex, HD_PATCH) for r in bands}
    oracle_err = max(float(np.abs(picked[r] - oracle[r]).max()) for r in bands)
    if not oracle_err < HD_ORACLE_TOL:
        raise AssertionError(f"F: resampled patches {oracle_err} from the float64 oracle")
    # a reading, not a check: JAX's float32 sample positions against the
    # same oracle
    f32_err = {r: float(np.abs(jax_f32_band(wsi_f, r, y0, x0, py, px, h_band, ex, HD_PATCH)
                               - oracle[r]).max()) for r in bands}
    logits_f = resample_logits(torch, reg_f, wsi_f, plan_f)
    hist = np.bincount(labels_f[mask > 0], minlength=N_CLASSES + 1)[1:].tolist()
    log(f"F: resampled patches of bands {bands} within {oracle_err:.3g} (0-255) of the "
        f"float64 oracle of the exact bin extents ({(time.perf_counter() - t0):.1f} s on "
        f"the host; bound {HD_ORACLE_TOL}); labels agree with the per-bin route (window "
        f"{HD_WINDOW_F}) on {agree:.4f} of bins (floor {HD_AGREE}; bins per class {hist}); "
        f"gather launches: register_dense {n_dense_f}, per-bin {n_per_bin_f}")
    log(f"F: float32 sample positions (the JAX package's arithmetic) against the same "
        f"oracle, per band: {json.dumps({str(r): e for r, e in f32_err.items()})}; largest "
        f"{max(f32_err.values()):.4g} (bound {HD_ORACLE_TOL})")

    # the gather at windows 32 and 58 over every bin of E and F
    for name, wsi, pos, w in (("E", wsi_e, pos_e, HD_PITCH_E), ("F", wsi_f, pos_f, HD_WINDOW_F)):
        y0g = torch.as_tensor(np.rint(pos["pxl_row_in_fullres"]).astype(np.int32) - w // 2,
                              device=dev)
        x0g = torch.as_tensor(np.rint(pos["pxl_col_in_fullres"]).astype(np.int32) - w // 2,
                              device=dev)
        n = len(y0g)
        kern = gather.gather_patches(wsi, y0g, x0g, w)
        plain = gather.gather_patches_plain(wsi, y0g, x0g, w)
        if not torch.equal(kern, plain):
            raise AssertionError(f"gather at window {w} differs from plain on slide {name}")
        del kern
        view = window_view(wsi[None], w)
        idx = clamped(y0g, x0g, torch.zeros_like(y0g), 1, wsi.shape[0], wsi.shape[1], w)
        idx = (idx[2], idx[0], idx[1])
        if not torch.equal(library_gather(view, *idx), plain):
            raise AssertionError(f"the library crop at window {w} differs from plain")
        del plain

        def fn(wsi=wsi, y0g=y0g, x0g=x0g, w=w):
            return gather.gather_patches(wsi, y0g, x0g, w)

        ms, issue_ms = cuda_ms(torch, fn, iters=10)
        symbol = "gather_bulk_kernel" if gather.bulk(w) else "gather_bytes_kernel"
        try:
            traced = "device {:.4f} ms ({})".format(
                *kernel_line(device_ms(torch, fn, 10, (symbol,))))
        except AssertionError as err:      # a reading: say what the trace held
            traced = f"device ms not measured ({err})"
        plain_ms, _ = cuda_ms(torch, lambda: gather.gather_patches_plain(wsi, y0g, x0g, w),
                              iters=3, warmup=1)
        library_ms, _ = cuda_ms(torch, lambda: library_gather(view, *idx), iters=5)
        path = "bulk-copy" if gather.bulk(w) else "byte"
        nbytes = 2 * n * w * w * 3 + 2 * n * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"gather at window {w} ({path} path) over every bin of {name} (N={n}): "
            f"bit-exact; {ms:.4f} ms per call (events; host issue {issue_ms:.4f} ms), "
            f"{traced}, plain "
            f"{plain_ms:.4f} ms, library (one aten::index on the unfold view) "
            f"{library_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes at 3.35 TB/s), "
            f"{bound / ms * 100:.1f} % of the bound [{card}]")

    # ms/slide and bins/s of the three routes; where each dense route's time goes
    times = {"exact": host_ms(lambda: reg_e.register_dense(wsi_e, pos_e, plan=plan_e)),
             "resample": host_ms(lambda: reg_f.register_dense(wsi_f, pos_f, plan=plan_f)),
             "per-bin": host_ms(lambda: reg_e(wsi_e, pos_e))}
    for name, (t, runs) in times.items():
        log(f"HD {name} route: {t:.2f} ms/slide (host clock, labels on the host, median of "
            f"3: {runs}), {n_fg / t * 1e3:.0f} in-tissue bins/s, "
            f"{HD_BINS * HD_BINS / t * 1e3:.0f} lattice bins/s [{card}]")
    with torch.inference_mode():
        wsi_d, oy_e, ox_e, yy_e, xx_e = reg_e._prepared_inputs(wsi_e, pos_e, 0)
        first = torch.zeros_like(yy_e)
        crops = reg_e._extract_flat(wsi_d[None], yy_e, xx_e, first)
        feats_e = reg_e._apply_f(crops)
        inside = np.asarray(fg_f)[:ey, :ex].reshape(-1) > 0
        keep = torch.as_tensor(np.flatnonzero(inside), device=dev)
        patches_f = torch.cat(list(reg_f._resampled_bands(wsi_f, y0, x0, py, px, h_band,
                                                          ey, ex)))[keep]
        feats_f = reg_f._apply_f(patches_f)
        oy_f, ox_f = (torch.as_tensor(a, device=dev) for a in np.nonzero(inside.reshape(ey, ex)))
        grid, _ = reg_e._scatter(feats_e[None], oy_e[None], ox_e[None])

        def labels(reg, feats, oy, ox):
            return reg._labels_from_grid(*reg._scatter(feats[None], oy[None], ox[None]))

        split = {
            "per-bin (and exact plans)": {
                "gather": cuda_ms(torch, lambda: reg_e._extract_flat(
                    wsi_d[None], yy_e, xx_e, first), 3, 1)[0],
                "f": cuda_ms(torch, lambda: reg_e._apply_f(crops), 3, 1)[0],
                "scatter+corrector": cuda_ms(torch, lambda: labels(
                    reg_e, feats_e, oy_e, ox_e), 3, 1)[0]},
            "resample": {"resample": cuda_ms(torch, lambda: [
                p for p in reg_f._resampled_bands(wsi_f, y0, x0, py, px, h_band, ey, ex)],
                3, 1)[0],
                "f": cuda_ms(torch, lambda: reg_f._apply_f(patches_f), 3, 1)[0],
                "scatter+corrector": cuda_ms(torch, lambda: labels(
                    reg_f, feats_f, oy_f, ox_f), 3, 1)[0]},
            "corrector alone": cuda_ms(torch, lambda: reg_e.corrector_apply(grid), 10)[0]}
        del crops, patches_f, feats_e, feats_f, grid
    log(f"HD stage split (CUDA events, ms a slide): {json.dumps(split)} [{card}]")
    for name, call in (("exact", lambda: reg_e.register_dense(wsi_e, pos_e, plan=plan_e)),
                       ("resample", lambda: reg_f.register_dense(wsi_f, pos_f, plan=plan_f))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = device_total_ms(prof)
        idle = f"{1 - busy / wall:.4f}" if busy > 0 else "not measured (no kernel events)"
        log(f"HD {name} route, one traced call: device {busy:.2f} ms of {wall:.2f} ms, idle "
            f"share {idle} [{card}]")
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))

    # register_slides over E F J E: one registrar plans one window, so the
    # window-32 directory registers E (twice) through register_dense, F and J
    # per bin; the window-58 directory registers F through register_dense
    e_file, f_file = os.path.join(tmp, "hdE.npy"), os.path.join(tmp, "hdF.npy")
    np.save(e_file, wsi_e.cpu().numpy())
    np.save(f_file, wsi_f.cpu().numpy())
    per_f32 = reg_e(wsi_f, pos_f)
    per_j = reg_e(wsi_e, pos_j)
    logits_j, _ = reg_e.register_logits(wsi_e, pos_j)
    logits_f32, _ = reg_e.register_logits(wsi_f, pos_f)
    refs = {0: (labels_e, logits_e), 1: (per_f32, logits_f32), 2: (per_j, logits_j),
            3: (labels_e, logits_e)}
    for reg, files, dirs, want_order, want_dense, want in (
            (reg_e, [e_file, f_file, e_file, e_file], [srd_e, srd_f, srd_j, srd_e],
             [0, 3, 2, 1], {0, 3}, refs),
            (reg_f, [f_file], [srd_f], [0], {0}, {0: (labels_f, logits_f)})):
        dense_pos = []
        plain_dense = reg.register_dense

        def counted(wsi, positions, pad_offset=0, plan=None, plain_dense=plain_dense,
                    dense_pos=dense_pos):
            dense_pos.append(positions)
            return plain_dense(wsi, positions, pad_offset, plan)

        reg.register_dense = counted
        source = ingest.SlideSource(files, dirs, hd_binning=HD_BINNING, prefetch=5,
                                    decode=np.load, device=dev)
        try:
            t0 = time.perf_counter()
            results = list(serving.register_slides(reg, files, dirs, hd_binning=HD_BINNING,
                                                   slide_batch=4, source=source))
            wall = time.perf_counter() - t0
        finally:
            del reg.register_dense
        order = [i for i, _, _ in results]
        dense = {i for i, _, p in results if any(p is q for q in dense_pos)}
        if order != want_order or dense != want_dense:
            raise AssertionError(f"register_slides yielded {order}, dense {sorted(dense)} "
                                 f"(want {want_order}, {sorted(want_dense)})")
        flips = 0
        for i, labels, _ in results:
            flips += serving.label_parity_report(want[i][0], labels, want[i][1])
            if not np.array_equal(labels > 0, mask > 0):
                raise AssertionError(f"register_slides slide {i}: foreground differs")
        per = {k: round(v * 1e3 / len(files), 2) for k, v in source.timer.summary().items()}
        log(f"register_slides (window {reg.window_size}) over {len(files)} HD slides: yield "
            f"order {order}, dense {sorted(dense)}, labels equal the direct calls' up to "
            f"{flips} near-tie flips; wall {wall * 1e3 / len(files):.2f} ms/slide, stage "
            f"ms/slide {json.dumps(per)} [{card}]")

    # the register command over E and F, decode swapped for np.load
    decode = ingest.decode_slide
    ingest.decode_slide = np.load
    try:
        for model_dir, image, srd, labels, logits in ((dir_e, e_file, srd_e, labels_e,
                                                       logits_e),
                                                      (dir_f, f_file, srd_f, labels_f,
                                                       logits_f)):
            out = os.path.join(tmp, os.path.basename(srd) + "_loupe.csv")
            t0 = time.perf_counter()
            cli.main(["register", "--model", model_dir, "--images", image, "--spaceranger",
                      srd, "--out", out, "--device", str(dev)])
            t_cli = time.perf_counter() - t0
            grid, n_rows = hd_grid_from_csv(out, classes)
            if n_rows != n_fg:
                raise AssertionError(f"HD CSV {out}: {n_rows} rows for {n_fg} bins")
            flips = serving.label_parity_report(labels, grid, logits)
            log(f"register command ({os.path.basename(model_dir)}, "
                f"{os.path.basename(srd)}): {t_cli:.2f} s with the model load; the CSV "
                f"names register_dense's labels up to {flips} near-tie flips")
    finally:
        ingest.decode_slide = decode
    return {"model_dir": dir_e, "srd": srd_e, "wsi": wsi_e, "labels": labels_e,
            "logits": logits_e, "registrar": reg_e, "plan": plan_e, "positions": pos_e}


# -- phase 13: the register command for every model kind --------------------------

SQ_BINS = 64                  # (c)'s lattice, cut from HD_BINS (PERF.md section 4)
SQ_PITCH, SQ_MARGIN = 32, 32  # 16 um bins at 32 px: an exact plan at 32-px patches
GCN_HIDDEN, GCN_DEPTH = 128, 3   # train-graph's defaults


def ascii_digits(values, width: int) -> np.ndarray:
    """(N, width) uint8 zero-padded decimal digits of non-negative ints."""
    return ((values[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
            + ord("0")).astype(np.uint8)


def write_mex(mat_dir, ids, symbols, barcodes=None, counts=None):
    """A feature-barcode matrix directory as Spaceranger writes it:
    ``features.tsv.gz`` (ID, symbol, type) and, with ``barcodes``,
    ``barcodes.tsv.gz`` and ``matrix.mtx.gz`` of the (genes, barcodes)
    single-digit integer ``counts`` in coordinate form (indices zero-padded
    to one width, so the lines are written as bytes)."""
    import gzip

    os.makedirs(mat_dir, exist_ok=True)
    with gzip.open(os.path.join(mat_dir, "features.tsv.gz"), "wt", compresslevel=1) as fh:
        fh.writelines(f"{i}\t{s}\tGene Expression\n" for i, s in zip(ids, symbols))
    if barcodes is None:
        return
    with gzip.open(os.path.join(mat_dir, "barcodes.tsv.gz"), "wt", compresslevel=1) as fh:
        fh.write("\n".join(barcodes) + "\n")
    if counts.max() > 9:
        raise ValueError("the byte writer takes single-digit counts")
    g, b = np.nonzero(counts)
    w = len(str(max(counts.shape)))
    sep = np.full((len(g), 1), ord(" "), np.uint8)
    body = np.concatenate([ascii_digits(g + 1, w), sep, ascii_digits(b + 1, w), sep,
                           ascii_digits(counts[g, b], 1),
                           np.full((len(g), 1), ord("\n"), np.uint8)], axis=1)
    with gzip.open(os.path.join(mat_dir, "matrix.mtx.gz"), "wb", compresslevel=1) as fh:
        fh.write(b"%%MatrixMarket matrix coordinate integer general\n%\n")
        fh.write(f"{counts.shape[0]} {counts.shape[1]} {len(g)}\n".encode())
        fh.write(body.tobytes())


def phase_kinds(torch, slides, mask, port, card, tmp, mm):
    """The register command for every model kind at full width: hex
    multimodal (scBERT + DenseNet-121; CountMLP + TpuPatchClassifier at
    window 160), square multimodal (per bin and dense ingest), square
    counts, HexGCN. ``mm`` is phase 9's request, ``mask`` slide 0's tissue.
    Returns (a)'s directory, slide 0's positions, the gene symbols, and (a)'s
    labels and logits (phase 18 (d) exports the directory)."""
    from gridnext_tpu_torch import cli, ingest, pipeline
    from gridnext_tpu_torch.data import graph_data
    from gridnext_tpu_torch.io.unify import unified_cache_path
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names
    from gridnext_tpu_torch.ops import favor_cuda

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    dev = slides.device
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    tpu_f = {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"}
    log(f"== phase 13: the register command for every model kind at full width ({MM_VOCAB} "
        f"genes; TF32 off)")

    # slide 0's Spaceranger directory: phase 4's positions, a unified cache of
    # phase 9's raw counts under feature IDs, and a MEX whose features.tsv.gz
    # maps the IDs to the gene2vec symbols
    t0 = time.perf_counter()
    srd, mask_w = write_spaceranger_dir(tmp, geometry, TISSUE_FRACTIONS[0], 0)
    if not np.array_equal(mask_w, mask):
        raise AssertionError("slide 0's positions differ from phase 4's")
    pos = io.read_positions(srd)
    keep = pos["in_tissue"] == 1
    y, x = np.divmod(np.flatnonzero(keep), geometry.VISIUM_W_ST)
    ids = [f"ENSG{i:011d}" for i in range(MM_VOCAB)]
    symbols = load_gene2vec_names()[:MM_VOCAB]
    counts = mm["raw"][y, x].T.astype(np.int64)               # (genes, spots)
    write_unified_cache(unified_cache_path(srd), ids,
                        [f"{c}_{r}" for c, r in zip(pos["array_col"][keep],
                                                    pos["array_row"][keep])], counts)
    write_mex(os.path.join(srd, "outs", "filtered_feature_bc_matrix"), ids, symbols,
              [b for b, k in zip(pos.barcodes, keep) if k], counts)
    slide0 = os.path.join(tmp, "slide0.npy")
    np.save(slide0, slides[0].cpu().numpy())
    n_spots = int(mask.sum())
    log(f"slide 0's directory: unified cache {os.path.getsize(unified_cache_path(srd)) / 1e6:.1f}"
        f" MB, MEX {np.count_nonzero(counts)} nonzeros, slide .npy, written in "
        f"{time.perf_counter() - t0:.1f} s")

    def route(name, args, n):
        """``cli.main(args)`` with decode swapped for np.load and the counts
        of the gather and FAVOR set to 0 just before and read just after:
        logs the wall time and stage split, returns the launches."""
        decode = ingest.decode_slide
        ingest.decode_slide = np.load
        try:
            torch.cuda.synchronize()
            gather.launches = favor_cuda.launches = 0
            t0 = time.perf_counter()
            stages = cli.main(["register", *args, "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"gather": gather.launches, "favor": favor_cuda.launches}
        finally:
            ingest.decode_slide = decode
        per = {k: round(v * 1e3, 2) for k, v in (stages or {}).items()}
        log(f"phase 13 {name}: register command {wall * 1e3:.2f} ms/slide with the model "
            f"load ({wall * 1e3 - sum(per.values()):.2f} ms outside the stages), stage ms "
            f"{json.dumps(per)}, {n / wall:.1f} in-tissue spots/s; launches "
            f"{json.dumps(launches)} [{card}]")
        return launches

    def check_launches(name, got, want):
        if got != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")

    # (a) scBERT + DenseNet-121: phase 9's model directory with its scBERT cut
    # to MM_STEP_DEPTH of its layers (phase 9 runs all of them), over phase
    # 9's counts; the reference is the same directory's model on phase 9's
    # request inputs
    meta_a = {**mm["meta"], "genes": ids, "n_genes": MM_VOCAB, "scbert_depth": MM_STEP_DEPTH}
    vars_a = scbert_depth_cut(mm["variables"], MM_STEP_DEPTH)
    dir_a = os.path.join(tmp, "model_mm_scbert")
    from_jax.save_model_dir(dir_a, meta_a, vars_a)
    out_a = os.path.join(tmp, "a.csv")
    got = route(f"(a) GridNetHexMM scBERT (depth {MM_STEP_DEPTH}) + DenseNet-121",
                ["--model", dir_a, "--images", slide0, "--spaceranger", srd, "--out", out_a],
                n_spots)
    want_favor = -(-geometry.VISIUM_H_ST * geometry.VISIUM_W_ST // COUNT_CHUNK) * MM_STEP_DEPTH
    check_launches("(a)", got, {"gather": 1, "favor": want_favor})
    grid, n_rows = loupe_grid(out_a, mask.shape, classes)
    if n_rows != n_spots or not np.array_equal(grid > 0, mask > 0):
        raise AssertionError("(a): the CSV's spots differ from the tissue")
    model_a = modeldir.mm_model_from_meta(meta_a, classes, vars_a, device=dev)
    x_count = modeldir.scbert_transform(symbols, MM_VOCAB)(mm["raw"])
    with torch.no_grad():
        logits_a = model_a((slide_grid(torch, slides[0], pos, port)[None],
                            torch.as_tensor(x_count, device=dev)[None]))[0].cpu().numpy()
    del model_a, x_count
    grid_a = grid
    flips = serving.label_parity_report(np.where(mask > 0, logits_a.argmax(-1) + 1, 0), grid,
                                        logits_a)
    log(f"(a): the CSV names the same model's direct forward on phase 9's request inputs up "
        f"to {flips} near-tie flips of {n_rows} spots; phase 9's request (depth "
        f"{MM_DEPTH}) {mm['ms']:.2f} ms")

    # (b) CountMLP + TpuPatchClassifier at window 160, log1p, the same
    # directory. The reference: the plain crop of the edge-padded slide, the
    # resize, a direct forward; the corrector's statistics are those of its
    # feature grid
    template = models.GridNetHexMM(models.TpuPatchClassifier(n_classes=N_CLASSES),
                                   models.CountMLP(MM_VOCAB, N_CLASSES), N_CLASSES)
    vars_b = random_variables(models, from_jax, seed=SEED + 12, model=template)
    del template
    meta_b = {"model": "GridNetHexMM", "classes": classes, "patch_px": PATCH,
              "window_px": WINDOW, "patch_chunk": CHUNK, "count_chunk": None, "genes": ids,
              "n_genes": MM_VOCAB, "log1p": True, "count_f": "mlp", "image_f": "tpu",
              "tpu_f": tpu_f, "hd_binning": None, "grid_dims": None, "dense_ingest": False}
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(pos)
    crops = gather.gather_patches_plain(pipeline.edge_pad(slides[0], WINDOW // 2),
                                        torch.as_tensor(y_px, device=dev),
                                        torch.as_tensor(x_px, device=dev), WINDOW)
    x_image = torch.zeros((geometry.VISIUM_H_ST, geometry.VISIUM_W_ST, PATCH, PATCH, 3),
                          device=dev)
    x_image[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        pipeline.resize_patches(crops, PATCH).float() / 255.0
    del crops
    x = (x_image[None], torch.as_tensor(np.log1p(mm["raw"]), device=dev)[None])
    model_b = modeldir.mm_model_from_meta(meta_b, classes, vars_b, device=dev)
    with torch.no_grad():
        vars_b = calibrated_bns(torch, model_b.corrector, model_b.patch_predictions(x),
                                vars_b)
        model_b = modeldir.mm_model_from_meta(meta_b, classes, vars_b, device=dev)
        logits_b = model_b(x)[0].cpu().numpy()
    del x_image, x, model_b
    dir_b = os.path.join(tmp, "model_mm_mlp")
    from_jax.save_model_dir(dir_b, meta_b, vars_b)
    out_b = os.path.join(tmp, "b.csv")
    got = route(f"(b) GridNetHexMM CountMLP + TpuPatchClassifier, window {WINDOW}",
                ["--model", dir_b, "--images", slide0, "--spaceranger", srd, "--out", out_b],
                n_spots)
    check_launches("(b)", got, {"gather": 1, "favor": 0})
    want_b = np.where(mask > 0, logits_b.argmax(-1) + 1, 0)
    grid, n_rows = loupe_grid(out_b, mask.shape, classes)
    if n_rows != n_spots:
        raise AssertionError(f"(b): {n_rows} CSV rows for {n_spots} spots")
    flips = serving.label_parity_report(want_b, grid, logits_b)
    hist = np.bincount(grid[mask > 0], minlength=N_CLASSES + 1)[1:].tolist()
    log(f"(b): the CSV names the labels of a direct forward on the plain crop + resize up "
        f"to {flips} near-tie flips (spots per class {hist})")

    # (d) HexGCN over slide 0's in-tissue spots, the MEX of phase 9's counts
    template = models.HexGCN(MM_VOCAB, N_CLASSES, GCN_HIDDEN, GCN_DEPTH)
    vars_d = random_variables(models, from_jax, seed=SEED + 16, model=template)
    del template
    meta_d = {"model": "HexGCN", "classes": classes, "hidden": GCN_HIDDEN,
              "depth": GCN_DEPTH, "log1p": True, "n_genes": MM_VOCAB,
              "feature_axis": graph_data.feature_axis_signature(srd)}
    dir_d = os.path.join(tmp, "model_graph")
    from_jax.save_model_dir(dir_d, meta_d, vars_d)
    out_d = os.path.join(tmp, "d.csv")
    got = route(f"(d) HexGCN hidden {GCN_HIDDEN}, depth {GCN_DEPTH}",
                ["--model", dir_d, "--spaceranger", srd, "--out", out_d], n_spots)
    check_launches("(d)", got, {"gather": 0, "favor": 0})
    gd = graph_data.visium_to_graphdata([srd])
    cpu_model = modeldir.graph_model_from_meta(meta_d, classes, vars_d, device="cpu")
    with torch.no_grad():
        node_logits = cpu_model(torch.from_numpy(np.log1p(gd["nodes"])),
                                torch.from_numpy(gd["edges"])).numpy()
    ox, oy = geometry.pseudo_hex_to_oddr(gd["pos"][:, 0], gd["pos"][:, 1])
    logits_d = np.zeros(mask.shape + (N_CLASSES,), np.float32)
    logits_d[oy, ox] = node_logits
    want_d = np.zeros(mask.shape, np.int64)
    want_d[oy, ox] = node_logits.argmax(-1) + 1
    grid, n_rows = loupe_grid(out_d, mask.shape, classes)
    if n_rows != n_spots or not np.array_equal(want_d > 0, mask > 0):
        raise AssertionError(f"(d): {n_rows} CSV rows / graph nodes for {n_spots} spots")
    flips = serving.label_parity_report(want_d, grid, logits_d)
    hist = np.bincount(grid[mask > 0], minlength=N_CLASSES + 1)[1:].tolist()
    log(f"(d): {gd['nodes'].shape[0]} nodes, {gd['edges'].shape[1]} edges; the CSV names "
        f"the CPU forward's labels up to {flips} near-tie flips (spots per class {hist})")

    # (c) a 64 x 64 square lattice of 16 um bins at 32 px
    srd_c, mask_c = write_hd_dir(tmp, "sq0", SQ_PITCH, SQ_MARGIN, n=SQ_BINS)
    side = 2 * SQ_MARGIN + SQ_BINS * SQ_PITCH
    slide_c = os.path.join(tmp, "sq0.npy")
    np.save(slide_c, make_slides(torch, 1, side, side, dev, HD_BLOCK, HD_NOISE)[0].cpu().numpy())
    pos_c = io.read_positions(srd_c, HD_BINNING)
    keep = pos_c["in_tissue"] == 1
    n_bins = int(keep.sum())
    write_unified_cache(unified_cache_path(srd_c, HD_BINNING), ids,
                        [f"{c}_{r}" for c, r in zip(pos_c["array_col"][keep],
                                                    pos_c["array_row"][keep])],
                        np.random.default_rng(SEED + 13).poisson(COUNT_RATE,
                                                                 (MM_VOCAB, n_bins)))
    write_mex(os.path.join(srd_c, "outs", "binned_outputs", HD_BINNING,
                           "filtered_feature_bc_matrix"), ids, symbols)
    square = {"classes": classes, "genes": ids, "n_genes": MM_VOCAB, "log1p": True,
              "hd_binning": HD_BINNING, "grid_dims": [SQ_BINS, SQ_BINS]}
    template = models.GridNetMM(models.TpuPatchClassifier(n_classes=N_CLASSES),
                                models.CountMLP(MM_VOCAB, N_CLASSES), N_CLASSES)
    vars_c = random_variables(models, from_jax, seed=SEED + 14, model=template)
    template = models.GridNet(models.CountMLP(MM_VOCAB, N_CLASSES), N_CLASSES,
                              f_dim=N_CLASSES)
    vars_n = random_variables(models, from_jax, seed=SEED + 15, model=template)
    del template
    labels_c = {}
    for name, meta, variables, args, want in (
            ("GridNetMM per bin", {**square, "model": "GridNetMM", "patch_px": SQ_PITCH,
                                   "window_px": None, "patch_chunk": HD_CHUNK,
                                   "count_chunk": None, "count_f": "mlp", "image_f": "tpu",
                                   "tpu_f": tpu_f, "dense_ingest": False},
             vars_c, ["--images", slide_c], {"gather": 1, "favor": 0}),
            ("GridNetMM dense ingest", {**square, "model": "GridNetMM", "patch_px": SQ_PITCH,
                                        "window_px": None, "patch_chunk": HD_CHUNK,
                                        "count_chunk": None, "count_f": "mlp",
                                        "image_f": "tpu", "tpu_f": tpu_f,
                                        "dense_ingest": True},
             vars_c, ["--images", slide_c], {"gather": 1, "favor": 0}),
            ("GridNet+CountMLP", {**square, "model": "GridNet+CountMLP"}, vars_n, [],
             {"gather": 0, "favor": 0})):
        model_dir = os.path.join(tmp, "model_" + name.replace(" ", "_").replace("+", "_"))
        from_jax.save_model_dir(model_dir, meta, variables)
        out = os.path.join(tmp, f"c_{len(labels_c)}.csv")
        got = route(f"(c) {name}, {SQ_BINS} x {SQ_BINS} bins",
                    ["--model", model_dir, *args, "--spaceranger", srd_c, "--out", out],
                    n_bins)
        check_launches(f"(c) {name}", got, want)
        grid, n_rows = hd_grid_from_csv(out, classes, SQ_BINS)
        if n_rows != n_bins or not np.array_equal(grid > 0, mask_c > 0):
            raise AssertionError(f"(c) {name}: the CSV's bins differ from the tissue")
        labels_c[name] = grid
    if not np.array_equal(labels_c["GridNetMM dense ingest"], labels_c["GridNetMM per bin"]):
        n = int((labels_c["GridNetMM dense ingest"] != labels_c["GridNetMM per bin"]).sum())
        raise AssertionError(f"(c): dense-ingest labels differ from per-bin at {n} bins")
    hist = {k: np.bincount(v[mask_c > 0], minlength=N_CLASSES + 1)[1:].tolist()
            for k, v in labels_c.items()}
    log(f"(c): {n_bins} in-tissue bins; dense-ingest labels equal the per-bin labels; bins "
        f"per class {json.dumps(hist)}")
    return {"model_dir": dir_a, "positions": pos, "symbols": symbols, "labels": grid_a,
            "logits": logits_a}



TRAIN_BATCH = 32              # train-image's --batch-size
TRAIN_LR = 1e-3               # train-image's --f-lr and --g-lr
TRAIN_TRACE_BATCHES = 8       # spotwise batches in the traced epoch (256 spots; cut from 20)
TRAIN_TIMED_BATCHES = 64      # spotwise batches timed untraced (cut from the epoch's 213)
SCBERT_BATCH, SCBERT_STEPS = 8, 8
MM_STEP_DEPTH = 2             # scBERT layers in (c)'s GridNetHexMM grid step (cut from 6)
TRAIN_TINT = 48               # +- intensity of a class's colour tint in its spots' windows
TRAIN_NOISE = 0.1             # share of spots whose annotation is another class
GRID_WINDOW = (24, 16)        # top-left cell of (b)'s 32 x 32 grid window


def scbert_depth_cut(variables, depth: int, key: str = "count_classifier") -> dict:
    """A GridNetHexMM variables tree whose scBERT count f keeps its first
    ``depth`` performer layers (the ``layers_i_*`` and ``wrap_i_*`` entries
    of ``params`` and ``favor`` for i >= depth dropped)."""
    def keep(name):
        parts = name.split("_")
        return not (parts[0] in ("layers", "wrap") and int(parts[1]) >= depth)

    out = dict(variables)
    for coll in ("params", "favor"):
        perf = variables[coll][key]["performer_lm"]["performer"]
        lm = {**variables[coll][key]["performer_lm"],
              "performer": {k: v for k, v in perf.items() if keep(k)}}
        out[coll] = {**variables[coll], key: {**variables[coll][key], "performer_lm": lm}}
    return out


def slide_grid(torch, slide, positions, port):
    """Phase 9's image grid of ``slide``: the /255 plain crops at its spots
    on the 78 x 64 lattice, zeros elsewhere."""
    geometry, _, _, _, _, _, serving, gather, _ = port
    dev = slide.device
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(positions)
    crops = gather.gather_patches_plain(
        slide, torch.as_tensor(y_px - PATCH // 2, device=dev),
        torch.as_tensor(x_px - PATCH // 2, device=dev), PATCH)
    grid = torch.zeros((geometry.VISIUM_H_ST, geometry.VISIUM_W_ST, PATCH, PATCH, 3),
                       device=dev)
    grid[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        crops.float() / 255.0
    return grid


def annotated_training_cohort(torch, slides, geometry, tmp):
    """Phase 4's four slides as a training cohort: Spaceranger dirs, the
    slides as ``.npy`` with each in-tissue spot's window tinted by its
    class's colour, and 7-class Loupe CSVs. The classes are the 7 angular
    sectors of each tissue ellipse (a spatial pattern the corrector can
    use), with ``TRAIN_NOISE`` of the spots relabelled from a numpy seed."""
    rng = np.random.default_rng(SEED + 20)
    tints = rng.integers(-TRAIN_TINT, TRAIN_TINT + 1, (N_CLASSES, 3))
    dirs, npys, csvs, masks, labels = [], [], [], [], []
    rows, cols, y_px, x_px = lattice(geometry)
    cx, cy = geometry.oddr_to_cartesian(cols, rows)
    sector = ((np.arctan2(cy - cy.mean(), cx - cx.mean()) + np.pi)
              / (2 * np.pi) * N_CLASSES).astype(np.int64) % N_CLASSES
    for i, frac in enumerate(TISSUE_FRACTIONS[:len(slides)]):
        root = os.path.join(tmp, f"cohort{i}")
        srd, mask = write_spaceranger_dir(root, geometry, frac, i)
        keep = mask.reshape(-1) > 0
        lab = sector.copy()
        noisy = rng.random(lab.shape) < TRAIN_NOISE
        lab[noisy] = rng.integers(0, N_CLASSES, int(noisy.sum()))
        wsi = slides[i].clone()
        half = PATCH // 2
        for c in range(N_CLASSES):
            sel = np.flatnonzero(keep & (lab == c))
            ys = torch.as_tensor(y_px[sel] - half, device=wsi.device)
            xs = torch.as_tensor(x_px[sel] - half, device=wsi.device)
            offs = torch.arange(PATCH, device=wsi.device)
            win = (ys[:, None, None] + offs[None, :, None],
                   xs[:, None, None] + offs[None, None, :])
            tinted = wsi[win].to(torch.int16) + torch.as_tensor(tints[c], device=wsi.device,
                                                               dtype=torch.int16)
            wsi[win] = tinted.clamp(0, 255).to(torch.uint8)
        npy = os.path.join(tmp, f"train_slide{i}.npy")
        np.save(npy, wsi.cpu().numpy())
        del wsi
        pos_barcodes = [f"S{i}BC{j:05d}-1" for j in range(len(keep))]
        csv_path = os.path.join(tmp, f"slide{i}_annotations.csv")
        with open(csv_path, "w", newline="") as fh:
            out = csv.writer(fh)
            out.writerow(["Barcode", "AARs"])
            out.writerows([pos_barcodes[j], f"Class_{lab[j] + 1}"] for j in np.flatnonzero(keep))
        dirs.append(srd)
        npys.append(npy)
        csvs.append(csv_path)
        masks.append(mask)
        labels.append(np.where(mask.reshape(-1) > 0, lab + 1, 0).reshape(mask.shape))
    return dirs, npys, csvs, masks, labels


def step_parity(torch, tl, from_jax, make_model, variables, x, y, loss_kind, dev):
    """One ``make_steps`` train step of the same weights on the card and on
    the CPU (float32), and on the card in float64 as the reference.

    Float32 cannot fix every gradient element: where BatchNorm's batch
    statistics cancel most of a gradient, its float32 value carries a
    relative error of up to ~1e-2 on either device (measured against
    float64), and Adam's first step moves an element by ``lr * g / (|g| +
    eps)``, so an element whose gradient float32 cannot resolve moves by up
    to lr either way. The check is that the card is as exact as the CPU:
    returns the loss's relative error and the BatchNorm statistics' max
    abs error (card vs CPU); per device, the worst relative error of a
    parameter's gradient against float64 (tensors whose float64 gradient
    is below 1e-6 of the largest, a zero true gradient, left out and
    counted) and the count of updated
    parameter elements more than 1e-4 from the float64 step; and the count
    of updated parameter elements more than 1e-4 apart, card vs CPU."""
    out = {}
    for where, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                         (dev, torch.float64)):
        model = make_model().to(dtype)
        tx = tl.make_adam(TRAIN_LR) if loss_kind == "spot" else \
            tl.make_gridwise_optimizer(TRAIN_LR)
        state = tl.create_train_state(model, tx, device=where, init=False)
        from_jax.load_variables(model, variables)
        grads = {}
        step = state.optimizer.step

        def capture(step=step, grads=grads, state=state):
            for path, t, _ in state.optimizer.entries:
                if t.grad is not None:
                    grads[path] = t.grad.detach().double().cpu()
            step()

        state.optimizer.step = capture
        train_step, _ = tl.make_steps(state, loss_kind)
        m = train_step(x.to(where, dtype), torch.as_tensor(y, device=where))
        params = {path: t.detach().double().cpu() for path, t, _ in state.optimizer.entries}
        stats = {path: t.detach().double().cpu() for path, t, _ in from_jax.model_entries(model)
                 if path[0] == "batch_stats"}
        out[(where.type, dtype)] = (float(m["loss"]), grads, params, stats)
        del model, state
    (l_card, g_card, p_card, s_card), (l_cpu, g_cpu, p_cpu, s_cpu), (_, g64, p64, _) = (
        out[(dev.type, torch.float32)], out[("cpu", torch.float32)],
        out[(dev.type, torch.float64)])
    res = {"loss": abs(l_card - l_cpu) / abs(l_cpu), "stats": 0.0, "apart": 0,
           "grad_card": 0.0, "grad_cpu": 0.0, "far_card": 0, "far_cpu": 0, "n": 0}
    top = max(float(g.norm()) for g in g64.values())
    res["zero_grad"] = 0
    for path, g in g64.items():
        scale = float(g.norm())
        if scale > 1e-6 * top:
            res["grad_card"] = max(res["grad_card"], float((g_card[path] - g).norm()) / scale)
            res["grad_cpu"] = max(res["grad_cpu"], float((g_cpu[path] - g).norm()) / scale)
        else:           # a zero true gradient (a bias before a BatchNorm)
            res["zero_grad"] += 1
        res["far_card"] += int(((p_card[path] - p64[path]).abs() > 1e-4).sum())
        res["far_cpu"] += int(((p_cpu[path] - p64[path]).abs() > 1e-4).sum())
        res["apart"] += int(((p_card[path] - p_cpu[path]).abs() > 1e-4).sum())
        res["n"] += g.numel()
    for path, t in s_cpu.items():
        res["stats"] = max(res["stats"], float((s_card[path] - t).abs().max()))
    return res


def check_step_parity(name, res):
    log(f"(b) {name}, card vs CPU (float32; float64 on the card the reference): loss rel err "
        f"{res['loss']:.3g}, updated BatchNorm statistics max abs err {res['stats']:.3g}; "
        f"worst gradient rel err against float64: card {res['grad_card']:.3g}, CPU "
        f"{res['grad_cpu']:.3g} ({res['zero_grad']} tensors of zero true gradient left "
        f"out); updated parameters more than 1e-4 from the float64 step: "
        f"card {res['far_card']}, CPU {res['far_cpu']} of {res['n']}; more than 1e-4 apart, "
        f"card vs CPU: {res['apart']}")
    if not (res["loss"] <= 1e-4 and res["stats"] <= 1e-4
            and res["grad_card"] <= 2 * res["grad_cpu"] + 1e-6
            and res["far_card"] <= 2 * res["far_cpu"] + 10):
        raise AssertionError(f"{name}: the card's step is less exact than the CPU's")


def centre_head(torch, sc, xb) -> None:
    """Centre an scBERT classifier's ``conv1`` bias on the mean token score
    of the batch ``xb``. With fresh head weights the token scores (conv1,
    then a ReLU) can all take one sign, and then no gradient reaches the
    attention; the mean, not the median: most tokens are the zero token
    and share one score, which the median would put on the ReLU's kink,
    where two routes' rounding picks the side."""
    conv1 = sc.performer_lm.head_module.conv1
    scores = []
    hook = conv1.register_forward_hook(lambda m, i, o: scores.append(o.detach()))
    with torch.no_grad():
        sc.eval()(xb)
    hook.remove()
    with torch.no_grad():
        conv1.bias -= scores[0].mean()


def favor_gradient_readings(torch, model, loss_of, dev, calls: int) -> dict:
    """The q/k/v projection gradients of ``loss_of()`` (a scalar from
    ``model``'s forward) through the kernel route, the plain route
    (FastAttention through ``favor_attention_plain``), the plain route with
    its output perturbed by FAVOR's forward tolerance (``FAVOR_RTOL``, 2e-4
    relative) and by 1e-2 (a planted fault). Each route is read against the
    plain one as the median over the projections of each one's relative
    gap (|g - g_plain| / |g_plain|), and as the worst projection's. The
    median grows with the forward error and barely moves from one draw of
    a perturbation to the next; the worst projection saturates (its
    gradient passes ReLU features whose kinks any forward change flips).
    The kernel route must make ``calls`` wrapper calls. Returns the losses
    of the kernel and plain routes, the readings (``limit``: the
    tolerance's median) and the kernel route's gradients."""
    from gridnext_tpu_torch.models import performer
    from gridnext_tpu_torch.ops import favor_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    kernel = performer.fused_generalized_linear_attention

    def perturbed(rel_err):
        def route(q, k, v, proj):
            out = favor_cuda.favor_attention_plain(q, k, v, proj)
            return out * (1 + rel_err * torch.randn(out.shape, generator=gen,
                                                    device=out.device))
        return route

    losses = []

    def weight_grads(route):
        performer.fused_generalized_linear_attention = route
        try:
            model.zero_grad(set_to_none=True)
            loss = loss_of()
            loss.backward()
            losses.append(float(loss.detach()))
        finally:
            performer.fused_generalized_linear_attention = kernel
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if any(k in n for k in ("to_q", "to_k", "to_v"))}

    favor_cuda.launches = 0
    g_kernel = weight_grads(kernel)
    if favor_cuda.launches != calls:
        raise AssertionError(f"the gradient check's step made {favor_cuda.launches} FAVOR "
                             f"calls, want {calls}")
    g_plain = weight_grads(favor_cuda.favor_attention_plain)
    g_tol = weight_grads(perturbed(FAVOR_RTOL))
    g_wrong = weight_grads(perturbed(1e-2))
    model.zero_grad(set_to_none=True)
    if min(float(g.norm()) for g in g_plain.values()) == 0.0:
        raise AssertionError("a q/k/v projection takes no gradient: the check would be void")

    def gaps(a):
        return [float((a[n] - g_plain[n]).norm() / g_plain[n].norm()) for n in g_plain]

    gap, worst = (float(f(gaps(g_kernel))) for f in (np.median, max))
    planted, planted_worst = (float(f(gaps(g_wrong))) for f in (np.median, max))
    return {"loss_kernel": losses[0], "loss_plain": losses[1], "gap": gap,
            "limit": float(np.median(gaps(g_tol))), "worst": worst, "planted": planted,
            "planted_worst": planted_worst, "n": len(g_plain), "grads": g_kernel}


def favor_gradient_gate(torch, model, loss_of, dev, what: str, calls: int) -> dict:
    """FAVOR's autograd at full width (:func:`favor_gradient_readings`):
    the kernel route's median gap within the limit, the kernel's forward
    tolerance carried through the step with no further factor; the planted
    fault's median at least twice the limit; no projection of the kernel
    route further off than the planted fault's worst (a wrong gradient in
    one projection). Returns the readings."""
    r = favor_gradient_readings(torch, model, loss_of, dev, calls)
    gap, limit, planted = r["gap"], r["limit"], r["planted"]
    log(f"{what}, kernel route vs plain route: median relative gap over the {r['n']} "
        f"projections {gap:.3g} (<= {limit:.3g}: the plain route's with FAVOR's output "
        f"perturbed by its tolerance, {FAVOR_RTOL:g} relative), worst projection "
        f"{r['worst']:.3g} (<= {r['planted_worst']:.3g}, the planted fault's worst); a "
        f"forward wrong by 1e-2 relative reads {planted:.3g} (>= 2x the limit)")
    if not gap <= limit:
        raise AssertionError(f"FAVOR's training gradients differ from the plain route's by a "
                             f"median {gap} (limit {limit})")
    if not r["worst"] <= r["planted_worst"]:
        raise AssertionError(f"a projection's gradient differs from the plain route's by "
                             f"{r['worst']}, more than a forward wrong by 1e-2 moves any "
                             f"({r['planted_worst']})")
    if not planted >= 2 * limit:
        raise AssertionError(f"a forward wrong by 1e-2 relative reads {planted}, under twice "
                             f"the limit {limit}: the check is void")
    return r


def phase_train(torch, slides, port, card, tmp, mm):
    """Phase 14: training at full width (module docstring), the cohort's
    slides ``.npy`` files (decode swapped for np.load). Returns the cohort
    (``dirs``, ``npys``, ``csvs``, ``masks``, ``truth``) and the trained
    directory (``model``) for phase 17."""
    from gridnext_tpu_torch import ingest

    decode = ingest.decode_slide
    ingest.decode_slide = np.load
    try:
        return train_phase(torch, slides, port, card, tmp, mm)
    finally:
        ingest.decode_slide = decode


def train_phase(torch, slides, port, card, tmp, mm):
    from torch.profiler import ProfilerActivity, profile, record_function

    from gridnext_tpu_torch import cli
    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.train import loops as tl

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    dev = slides.device
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    t_phase = time.perf_counter()
    laps = {}
    log(f"== phase 14: training at full width: train-image (DenseNet-121 f, GridNetHex g, "
        f"{PATCH}-px patches, batch {TRAIN_BATCH}, patch_chunk {CHUNK}), one step on the "
        f"card against the CPU, scBERT spotwise and one multimodal grid step (TF32 off)")
    torch.cuda.reset_peak_memory_stats()

    # (a) the train-image command, then --resume, then register
    dirs, npys, csvs, masks, truth = annotated_training_cohort(torch, slides, geometry, tmp)
    n_spots = int(sum(int(m.sum()) for m in masks))
    out = os.path.join(tmp, "model_train_image")
    argv = ["train-image", "--spaceranger", *dirs, "--annots", *csvs, "--images", *npys,
            "--out", out, "--batch-size", str(TRAIN_BATCH), "--patch-px", str(PATCH),
            "--patch-chunk", str(CHUNK), "--device", str(dev)]
    n_val = max(1, n_spots // 5)
    want_gather = (-(-(n_spots - n_val) // TRAIN_BATCH) + -(-n_val // TRAIN_BATCH)
                   + len(dirs))
    walls = []
    for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
        torch.cuda.synchronize()
        gather.launches = 0
        t0 = time.perf_counter()
        cli.main(argv + extra)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        log(f"train-image {' '.join(extra)}: {walls[-1]:.2f} s, {gather.launches} "
            f"gather launches ({want_gather} expected: one per spot batch and grid)")
        if gather.launches != want_gather:
            raise AssertionError(f"train-image: {gather.launches} gather launches, "
                                 f"want {want_gather}")
    latest = from_jax.load_checkpoint(os.path.join(out, "g_state.msgpack.latest"))
    if latest["epochs_done"] != 2 or latest["step"] != 2 * 3:
        raise AssertionError(f"the resumed run ended at epoch {latest['epochs_done']}, "
                             f"step {latest['step']}")
    # register slide 3 with the trained directory through the command
    csv_out = os.path.join(tmp, "trained.csv")
    cli.main(["register", "--model", out, "--spaceranger", dirs[3], "--images", npys[3],
              "--out", csv_out, "--device", str(dev)])
    meta, classes_m, variables = from_jax.load_model_dir(out)
    if list(classes_m) != classes or meta["model"] != "GridNetHex+DenseNet121":
        raise AssertionError(f"trained directory: classes {classes_m}, model {meta['model']}")
    grid, n_rows = loupe_grid(csv_out, masks[3].shape, classes)
    if n_rows != int(masks[3].sum()) or not np.array_equal(grid > 0, masks[3] > 0):
        raise AssertionError("trained register: the CSV's spots differ from the tissue")
    # the same weights on the CPU: the registrar's f32 modules, plain crop
    reg_cpu = modeldir.image_registrar_from_meta(meta, classes_m, variables, device="cpu")
    pos3 = io.read_positions(dirs[3])
    wsi3 = torch.from_numpy(np.load(npys[3]))
    t0 = time.perf_counter()
    logits_cpu, fg_cpu = reg_cpu.register_logits(wsi3, pos3)
    t_cpu = time.perf_counter() - t0
    want = np.where(fg_cpu > 0, logits_cpu.argmax(-1) + 1, 0)
    flips = serving.label_parity_report(want, grid, logits_cpu)
    acc = float((grid[masks[3] > 0] == truth[3][masks[3] > 0]).mean())
    # g_state.msgpack reads back bit-equal through the bridge
    g = modeldir.grid_model_from_meta(meta, classes_m, variables, device="cpu")
    back = from_jax.jax_variables(g)
    for path, a in tree_leaves(back):
        b = variables
        for k in path:
            b = b[k]
        if not np.array_equal(a, b):
            raise AssertionError(f"g_state.msgpack: {'/'.join(path)} does not read back")
    log(f"(a) train-image over {len(dirs)} arrays, {n_spots} annotated spots: epoch 1 "
        f"{walls[0]:.2f} s, --resume to epoch 2 {walls[1]:.2f} s; register of slide 3: "
        f"labels equal to the CPU forward of the same weights ({t_cpu:.1f} s) up to {flips} "
        f"near-tie flips of {n_rows} spots; accuracy against the annotations {acc:.4f} "
        f"(chance {1 / N_CLASSES:.3f}); g_state.msgpack reads back bit-equal [{card}]")
    laps["(a)"] = time.perf_counter()

    # the spotwise epoch's numbers, on the command's dataset and split
    spots = create_visium_dataset(dirs, spatial=False, use_count=False, annot_files=csvs,
                                  fullres_image_files=npys, patch_size_px=PATCH,
                                  device=dev)
    order = np.random.default_rng(0).permutation(len(spots))[n_val:]
    batches = [order[i:i + TRAIN_BATCH]
               for i in range(0, len(order), TRAIN_BATCH)][:TRAIN_TIMED_BATCHES]
    f = models.densenet121(num_classes=N_CLASSES)
    state = tl.create_train_state(f, tl.make_adam(TRAIN_LR), device=dev)
    train_step, _ = tl.make_steps(state, "spot")
    spots.batch(batches[0])                       # decode and stack the slides
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        x, y = tl._pad_batch(*spots.batch(b), TRAIN_BATCH, "spot")
        train_step(x, torch.as_tensor(y, device=dev))
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    n_steps = len(batches)
    # a traced spotwise epoch over TRAIN_TRACE_BATCHES batches: the device
    # time a step of each part (the kernels by the range their launch fell
    # in) and the device's busy time a step, against the untraced epoch's
    # wall time a step (the tracer slows the host)
    optimiser_step = state.optimizer.step

    def ranged_optimiser_step():
        with record_function("optimiser"):
            optimiser_step()

    state.optimizer.step = ranged_optimiser_step
    traced = batches[:TRAIN_TRACE_BATCHES]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in traced:
            with record_function("crop"):
                xc, yc = spots.batch(b)
            x, y = tl._pad_batch(xc, yc, TRAIN_BATCH, "spot")
            y = torch.as_tensor(y, device=dev)
            with record_function("forward + backward"):
                train_step(x, y)
        torch.cuda.synchronize()
        t_traced = time.perf_counter() - t0
    trace = os.path.join(tmp, "train_trace.json")
    t0 = time.perf_counter()
    busy = staging_overlap(prof, trace)["device_busy_ms"] / len(traced)
    part = {k: v / len(traced) for k, v in device_ms_by_range(
        trace, ("crop", "forward + backward", "optimiser")).items()}
    t_parse = time.perf_counter() - t0
    step_ms = t_epoch * 1e3 / n_steps
    log(f"spotwise steps (the epoch's first {n_steps} of {TRAIN_BATCH}): {t_epoch:.2f} s, "
        f"{n_steps / t_epoch:.2f} steps/s, {n_steps * TRAIN_BATCH / t_epoch:.1f} patches/s; "
        f"the traced "
        f"epoch {t_traced:.2f} s, its trace's export and parse {t_parse:.2f} s [{card}]")
    log(f"traced spotwise epoch ({len(traced)} batches): device ms a step: crop "
        f"{part['crop']:.3f}, forward + backward {part['forward + backward']:.3f}, "
        f"optimiser {part['optimiser']:.3f}, the rest {part['other']:.3f}; busy "
        f"{busy:.3f} ms a step. Epoch split ({n_steps} steps at the untraced "
        f"{step_ms:.3f} ms a step): crop {part['crop'] * n_steps / 1e3:.3f} s, forward + "
        f"backward {part['forward + backward'] * n_steps / 1e3:.3f} s, optimiser "
        f"{part['optimiser'] * n_steps / 1e3:.3f} s, device idle (the host) "
        f"{t_epoch - busy * n_steps / 1e3:.3f} s; idle share {1 - busy / step_ms:.3f} "
        f"untraced ({1 - busy * len(traced) / (t_traced * 1e3):.3f} against the traced "
        f"wall, {t_traced * 1e3 / len(traced):.3f} ms a step) [{card}]")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    del spots, state, f, prof

    # a grid step: the grid model as the command trains it (f frozen)
    grids = create_visium_dataset(dirs[:1], use_count=False, annot_files=csvs[:1],
                                  fullres_image_files=npys[:1], patch_size_px=PATCH,
                                  device=dev)
    gx, gy = grids[0]
    gmodel = models.GridNetHex(models.densenet121(num_classes=N_CLASSES), N_CLASSES,
                               N_CLASSES, patch_chunk=CHUNK)
    gstate = tl.create_train_state(gmodel, tl.make_gridwise_optimizer(TRAIN_LR), device=dev)
    from_jax.load_variables(gmodel, variables)
    grid_step, _ = tl.make_steps(gstate, "grid")
    gyt = torch.as_tensor(gy[None], device=dev)
    grid_ms = cuda_ms(torch, lambda: grid_step(gx[None], gyt), 3, warmup=1)[0]
    log(f"grid step (GridNetHex, frozen DenseNet-121 over {gx.shape[0] * gx.shape[1]} cells, "
        f"no_grad f): {grid_ms:.1f} ms, {1e3 / grid_ms:.3f} grid steps/s [{card}]")
    laps["timings"] = time.perf_counter()
    del gstate, gmodel

    # (b) one step on the card against the same step on the CPU
    dn_vars = random_variables(models, from_jax, seed=SEED + 21,
                               model=models.densenet121(num_classes=N_CLASSES))
    sel = np.flatnonzero(gy.reshape(-1) > 0)[:TRAIN_BATCH]
    xb = gx.reshape((-1,) + tuple(gx.shape[2:]))[torch.as_tensor(sel, device=dev)]
    check_step_parity(f"DenseNet-121 spotwise step (batch {TRAIN_BATCH})", step_parity(
        torch, tl, from_jax, lambda: models.densenet121(num_classes=N_CLASSES), dn_vars,
        xb, gy.reshape(-1)[sel] - 1, "spot", dev))
    g_vars = random_variables(models, from_jax, seed=SEED + 22, model=models.GridNetHex(
        models.densenet121(num_classes=N_CLASSES), N_CLASSES, N_CLASSES))
    # a 32 x 32 window of the grid (from an even row: the odd-right parity
    # holds): the CPU's f over 4,992 cells would take a minute
    win = (slice(GRID_WINDOW[0], GRID_WINDOW[0] + 32), slice(GRID_WINDOW[1], GRID_WINDOW[1] + 32))
    check_step_parity("GridNetHex grid step (frozen DenseNet-121 f, 32 x 32 cells)", step_parity(
        torch, tl, from_jax, lambda: models.GridNetHex(
            models.densenet121(num_classes=N_CLASSES), N_CLASSES, N_CLASSES,
            patch_chunk=CHUNK), g_vars, gx[win][None].cpu(), gy[win][None], "grid", dev))
    laps["(b)"] = time.perf_counter()
    del gx, grids

    # (c) scBERT spotwise at full width through the FAVOR kernel
    genes = load_gene2vec_names()[:MM_VOCAB]
    rng = np.random.default_rng(SEED + 23)
    n_items = SCBERT_BATCH * SCBERT_STEPS
    xs = np.minimum(rng.poisson(0.4, (n_items, MM_VOCAB)), 7).astype(np.float32)
    ys = rng.integers(0, N_CLASSES, n_items)
    sc_kw = dict(n_genes=MM_VOCAB, dim=MM_DIM, depth=MM_DEPTH, heads=MM_HEADS,
                 dim_head=MM_DIM_HEAD, n_classes=N_CLASSES, generalized_attention=True)
    # weights from a numpy seed (random_variables: from flax's init, with
    # embeddings of scale dim^-1/2, every position of the last LayerNorm can
    # be the same vector)
    sc = models.scBERT(**sc_kw)
    sc_state = tl.create_train_state(sc, tl.make_adam(TRAIN_LR), device=dev, init=False)
    from_jax.load_variables(sc, random_variables(models, from_jax, seed=SEED + 24, model=sc))
    xb = torch.as_tensor(xs[:SCBERT_BATCH], device=dev)
    yb = torch.as_tensor(ys[:SCBERT_BATCH], device=dev)
    centre_head(torch, sc, xb)
    sc.train()
    favor_gradient_gate(torch, sc, lambda: tl._spot_loss(sc(xb), yb)[0], dev,
                        f"(c) the step's q/k/v projection gradients over {MM_DEPTH} FAVOR "
                        f"calls at ({SCBERT_BATCH}, {MM_HEADS}, {MM_VOCAB + 1}, "
                        f"{MM_DIM_HEAD})", MM_DEPTH)
    favor_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc_state, _, hist = tl.train_spotwise(sc, {"train": (xs, ys)}, num_epochs=1,
                                          batch_size=SCBERT_BATCH, state=sc_state,
                                          verbose=False, device=dev)
    torch.cuda.synchronize()
    t_sc = time.perf_counter() - t0
    want_favor = SCBERT_STEPS * MM_DEPTH
    log(f"(c) scBERT train_spotwise ({SCBERT_STEPS} steps of {SCBERT_BATCH}): {t_sc:.2f} s, "
        f"{SCBERT_STEPS / t_sc:.3f} steps/s, loss {hist[0]:.4f}; {favor_cuda.launches} FAVOR "
        f"wrapper calls ({want_favor} expected: {MM_DEPTH} per step, 3 CUDA kernels each)")
    if favor_cuda.launches != want_favor or not np.isfinite(hist[0]):
        raise AssertionError(f"scBERT training: {favor_cuda.launches} FAVOR calls, loss "
                             f"{hist[0]}")
    del sc, sc_state
    laps["(c) scBERT"] = time.perf_counter()

    # one gridwise step of GridNetHexMM (scBERT + DenseNet-121, both frozen),
    # its scBERT cut to MM_STEP_DEPTH layers (phase 9 runs the full depth)
    mm_model = modeldir.mm_model_from_meta(
        {**mm["meta"], "scbert_depth": MM_STEP_DEPTH}, classes,
        scbert_depth_cut(mm["variables"], MM_STEP_DEPTH), device=dev)
    mm_state = tl.create_train_state(mm_model, tl.make_gridwise_optimizer(TRAIN_LR),
                                     device=dev, init=False)
    if any(p.requires_grad for p in mm_model.image_classifier.parameters()) or any(
            p.requires_grad for p in mm_model.count_classifier.parameters()):
        raise AssertionError("a frozen f takes gradients")
    mask0 = masks[0] > 0
    x_image = slide_grid(torch, slides[0], io.read_positions(dirs[0]), port)
    x_count = torch.as_tensor(modeldir.scbert_transform(genes, MM_VOCAB)(mm["raw"]),
                              device=dev)
    mm_step, _ = tl.make_steps(mm_state, "grid")
    favor_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = mm_step((x_image[None], x_count[None]),
                torch.as_tensor(np.where(mask0, truth[0], 0)[None], device=dev))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    t_mm = time.perf_counter() - t0
    want_mm = -(-geometry.VISIUM_H_ST * geometry.VISIUM_W_ST // COUNT_CHUNK) * MM_STEP_DEPTH
    log(f"(c) GridNetHexMM grid step (scBERT at depth {MM_STEP_DEPTH} + DenseNet-121 frozen, "
        f"{geometry.VISIUM_H_ST} x "
        f"{geometry.VISIUM_W_ST} cells): {t_mm:.2f} s, loss {loss:.4f}, {favor_cuda.launches} "
        f"FAVOR calls ({want_mm} expected) [{card}]")
    if favor_cuda.launches != want_mm or not np.isfinite(loss):
        raise AssertionError("the multimodal grid step did not run through the kernel")
    laps["(c) GridNetHexMM"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prev, parts = t_phase, []
    for name, t in laps.items():
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({', '.join(parts)} s), peak device "
        f"memory {peak:.2f} GiB [{card}]")
    return {"dirs": dirs, "npys": npys, "csvs": csvs, "masks": masks, "truth": truth,
            "model": out}


# -- phase 15: the count data tier ------------------------------------------------

TIER_ARRAYS = 4               # the cohort of JAX's simulate default (--arrays 4)
TIER_GENES = 16906            # the gene2vec vocabulary: never cut
TIER_EPOCHS = 2               # train-count's --epochs (JAX's default 10)
TIER_READS = 3                # host-clock reads of the codec a cache (median)
TIER_LINE_READS = 1           # reads of the former line reader (the yardstick), cut from 3
TIER_READ_ARRAYS = 2          # arrays whose cache (c) reads three ways, cut from 4


def _row_values(fields: bytes, n: int) -> np.ndarray:
    """One row's tab-separated numbers (the former line reader's)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            values = np.fromstring(fields, dtype=np.float64, sep="\t")
        except (DeprecationWarning, ValueError):
            values = None
    if values is not None and len(values) == n:
        return values
    cells = fields.split(b"\t")
    if len(cells) != n:
        raise ValueError(f"a row has {len(cells)} values for {n} columns")
    return np.array([float(c) if c.strip() else np.nan for c in cells], np.float64)


def line_reader(count_file):
    """The package's former unified-cache reader, the yardstick of the codec:
    ``gzip`` on one thread and one ``np.fromstring`` a row."""
    import gzip

    with gzip.open(str(count_file), "rb") as fh:
        header = fh.readline().rstrip(b"\r\n").split(b"\t")
        columns = [c.decode() for c in header[1:]]
        genes, rows = [], []
        for line in fh:
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            name, _, fields = line.partition(b"\t")
            genes.append(name.decode())
            rows.append(_row_values(fields, len(columns)))
    return genes, columns, np.stack(rows)


def csv_label_grid(path, positions, classes, shape):
    """The (78, 64) label grid a Loupe CSV names through ``positions``
    (class code + 1; 0 where no row names a spot) and its row count."""
    from gridnext_tpu_torch import geometry

    where = {b: i for i, b in enumerate(positions.barcodes)}
    grid = np.zeros(shape, np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))[1:]
    for barcode, annot in rows:
        i = where[barcode]
        x, y = geometry.pseudo_hex_to_oddr(positions["array_col"][i], positions["array_row"][i])
        grid[y, x] = classes.index(annot) + 1
    return grid, len(rows)


def phase_count_tier(torch, card, tmp, dev) -> dict:
    """Phase 15: simulate, prepare, the three readers, train-count and
    register through the port's commands at 16,906 genes; returns the
    numbers it printed, the cohort's directories, the trained directory
    and array 0's reference labels, logits and CSV (phase 18 serves it)."""
    import shutil

    from gridnext_tpu_torch import cli, modeldir, serving
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.data import CountGridDataset, create_visium_dataset
    from gridnext_tpu_torch.io import read_positions, tsv_codec, unify
    from gridnext_tpu_torch.observability import StageTimer
    from gridnext_tpu_torch.train import loops as tl

    t_phase = time.perf_counter()
    log(f"== phase 15: the count data tier at full width: simulate, prepare, the cache "
        f"readers, train-count and register over {TIER_ARRAYS} arrays of {TIER_GENES} genes")
    out = {}
    root = os.path.join(tmp, "cohort")
    t0 = time.perf_counter()
    cli.main(["simulate", "--out", root, "--arrays", str(TIER_ARRAYS), "--genes",
              str(TIER_GENES), "--gene2vec-names", "--seed", str(SEED)])
    out["simulate_s"] = time.perf_counter() - t0
    dirs = [os.path.join(root, f"a{i}") for i in range(TIER_ARRAYS)]
    mex = sum(os.path.getsize(os.path.join(d, "outs", "filtered_feature_bc_matrix",
                                           "matrix.mtx.gz")) for d in dirs)
    log(f"(a) simulate: {out['simulate_s']:.2f} s for {TIER_ARRAYS} arrays "
        f"({mex / 1e6:.1f} MB of gzip MEX) [{card}]")

    # (b) prepare, with the stage split of prepare_count_files
    timer = StageTimer()
    prepare = unify.prepare_count_files
    unify.prepare_count_files = functools.partial(prepare, timer=timer)
    try:
        t0 = time.perf_counter()
        cli.main(["prepare", "--spaceranger", *dirs])
        out["prepare_s"] = time.perf_counter() - t0
    finally:
        unify.prepare_count_files = prepare
    laps = out["prepare_split_s"] = timer.summary()
    caches = [unify.unified_cache_path(d) for d in dirs]
    log(f"(b) prepare: {out['prepare_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in laps.items()) + f" s) [{card}]")

    # (c) three readers, median of TIER_READS host-clock reads each
    reads = []
    for i, cfile in enumerate(caches[:TIER_READ_ARRAYS]):
        if tsv_codec.gzip_member_format(cfile) != "native":
            raise AssertionError(f"{cfile}: prepare did not write the GX member chain")
        single = os.path.join(tmp, f"single{i}.unified.tsv.gz")
        genes, columns, values = tsv_codec.read_tsv_matrix(cfile)
        write_unified_cache(single, genes, columns, values)
        if tsv_codec.gzip_member_format(single) != "foreign":
            raise AssertionError("write_unified_cache wrote a GX member chain")
        row = {"array": i, "genes": len(genes), "spots": len(columns),
               "gzip_mb": os.path.getsize(cfile) / 1e6,
               "single_gzip_mb": os.path.getsize(single) / 1e6}
        results = {}
        for name, fn, path in (("line_reader", line_reader, cfile),
                               ("codec_gx", tsv_codec.read_tsv_matrix, cfile),
                               ("codec_single", tsv_codec.read_tsv_matrix, single)):
            times = []
            for _ in range(TIER_LINE_READS if name == "line_reader" else TIER_READS):
                t0 = time.perf_counter()
                results[name] = fn(path)
                times.append(time.perf_counter() - t0)
            row[f"{name}_s"] = float(np.median(times))
        for name, (g, c, v) in results.items():
            if g != genes or c != columns or not np.array_equal(v, values):
                raise AssertionError(f"array {i}: {name} reads other (genes, columns, "
                                     "values) than the codec")
        del results
        row["speedup_gx"] = row["line_reader_s"] / row["codec_gx_s"]
        row["speedup_single"] = row["line_reader_s"] / row["codec_single_s"]
        reads.append(row)
        log(f"(c) array {i}: {len(genes)} genes x {len(columns)} spots, "
            f"{row['gzip_mb']:.1f} MB GX gzip; median of {TIER_READS} (line reader "
            f"{TIER_LINE_READS}): line reader "
            f"{row['line_reader_s']:.3f} s, codec on the GX chain {row['codec_gx_s']:.3f} s "
            f"({row['speedup_gx']:.2f}x), codec on the single member "
            f"{row['codec_single_s']:.3f} s ({row['speedup_single']:.2f}x); all three "
            f"equal ({tsv_codec.workers()} codec threads) [{card}]")
    out["reads"] = reads

    # (d) train-count on the card: the stages timed, the grid loss falls
    annots = [os.path.join(d, f"a{i}_annotations.csv") for i, d in enumerate(dirs)]
    model = os.path.join(tmp, "model_count_tier")
    stages, histories = {}, []
    spot_stage, grid_stage, train_gridwise = cli._spot_stage, cli._grid_stage, tl.train_gridwise
    import gridnext_tpu_torch.train as train_pkg

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                stages[name] = time.perf_counter() - t0
        return run

    def recorded(*a, **kw):
        res = train_gridwise(*a, **kw)
        histories.append(list(res[2]))
        return res

    cli._spot_stage, cli._grid_stage = timed("spot", spot_stage), timed("grid", grid_stage)
    train_pkg.train_gridwise = recorded
    try:
        t0 = time.perf_counter()
        cli.main(["train-count", "--spaceranger", *dirs, "--annots", *annots, "--out", model,
                  "--epochs", str(TIER_EPOCHS), "--device", str(dev)])
        out["train_s"] = time.perf_counter() - t0
    finally:
        cli._spot_stage, cli._grid_stage = spot_stage, grid_stage
        train_pkg.train_gridwise = train_gridwise
    grid_loss = histories[0]
    if not (len(grid_loss) == TIER_EPOCHS and grid_loss[1] < grid_loss[0]):
        raise AssertionError(f"train-count: the grid stage's training loss {grid_loss} "
                             "did not fall from epoch 1 to epoch 2")
    out.update(spot_stage_s=stages["spot"], grid_stage_s=stages["grid"], grid_loss=grid_loss)
    log(f"(d) train-count, {TIER_EPOCHS} epochs: {out['train_s']:.2f} s, spot stage "
        f"{stages['spot']:.2f} s, grid stage {stages['grid']:.2f} s; grid training loss "
        f"{grid_loss[0]:.4f} -> {grid_loss[1]:.4f} [{card}]")

    # (e) register each array through the trained directory
    meta, classes, variables = from_jax.load_model_dir(model)
    classes = list(classes)
    n_genes = len(tsv_codec.read_row_names(caches[0]))
    if meta["model"] != "GridNetHex+CountMLP" or meta["n_genes"] != n_genes:
        raise AssertionError(f"train-count wrote {meta['model']} over {meta['n_genes']} genes "
                             f"(the caches hold {n_genes})")
    net = modeldir.grid_model_from_meta(meta, classes, variables, device=dev)
    out["register"] = []
    for i, (srd, cfile) in enumerate(zip(dirs, caches)):
        csv_out = os.path.join(tmp, f"tier{i}.csv")
        t0 = time.perf_counter()
        cli.main(["register", "--model", model, "--spaceranger", srd, "--out", csv_out,
                  "--device", str(dev)])
        t_reg = time.perf_counter() - t0
        x, _ = CountGridDataset([cfile])[0]
        fg = x.sum(-1) > 0
        with torch.no_grad():
            logits = net(torch.as_tensor(np.log1p(x)[None], device=dev))[0].float().cpu().numpy()
        want = np.where(fg, logits.argmax(-1) + 1, 0)
        positions = read_positions(srd)
        got, n_rows = csv_label_grid(csv_out, positions, classes, fg.shape)
        if n_rows != int(fg.sum()) or not np.array_equal(got > 0, fg):
            raise AssertionError(f"register of array {i}: the CSV's spots differ from the "
                                 "cache's")
        flips = serving.label_parity_report(want, got, logits)
        truth, _ = csv_label_grid(annots[i], positions, classes, fg.shape)
        acc = float((got[fg] == truth[fg]).mean())
        out["register"].append({"array": i, "s": t_reg, "flips": flips, "accuracy": acc,
                                "spots": n_rows})
        if i == 0:
            ref0 = {"labels": want, "logits": logits, "csv": csv_out}
        log(f"(e) register of array {i}: {t_reg:.2f} s with the model load; labels equal "
            f"to the directory's forward on the CountGridDataset grid up to {flips} "
            f"near-tie flips of {n_rows} spots; foreground accuracy against the simulated "
            f"annotations {acc:.4f} (chance {1 / len(classes):.3f}) [{card}]")

    # (f) two caches with reversed gene axes: the factory raises
    bad = []
    for i in range(2):
        d = os.path.join(tmp, "misaligned", f"m{i}")
        os.makedirs(os.path.join(d, "outs", "spatial"))
        shutil.copy(os.path.join(dirs[i], "outs", "spatial", "tissue_positions.csv"),
                    os.path.join(d, "outs", "spatial"))
        genes, columns, values = tsv_codec.read_tsv_matrix(caches[i])
        if i == 1:
            genes, values = genes[::-1], values[::-1]
        tsv_codec.write_tsv_matrix(unify.unified_cache_path(d), genes, columns, values,
                                   force_int=True)
        bad.append(d)
    try:
        create_visium_dataset(bad, use_image=False, annot_files=None, device=dev)
    except ValueError as e:
        if "count files do not share a gene axis" not in str(e):
            raise
        log(f"(f) reversed gene axes: the factory raised ValueError: {str(e)[:96]}...")
    else:
        raise AssertionError("the factory took two caches with reversed gene axes")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['phase_s']:.1f} s [{card}]")
    log(json.dumps({"count_tier": out}))
    out.update(dirs=dirs, model=model, ref0=ref0)
    return out


# -- phase 16: scBERT pretraining, fine-tuning and train-graph ----------------------

PRETRAIN_BATCH = 4            # pretrain-scbert's --batch-size (its default)
PRETRAIN_REDRAW = 100         # --redraw-every: ~278 train steps give 2 redraws
PRETRAIN_TRACE_STEPS = 6      # MLM steps in (b)'s traced window
FINETUNE_LR = 1e-4            # train-mm's --f-lr default for the scBERT count f
GRAPH_STEPS = 200             # train-graph's --steps default


def device_ms_by_kernel(path) -> dict:
    """From a Chrome trace at ``path``: device ms of the FAVOR kernels, of
    the matrix products (cuBLAS / CUTLASS GEMM kernels) and of every other
    device event, and the device's busy ms (their union)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {"favor": 0.0, "gemm": 0.0, "other": 0.0}
    spans = []
    for e in events:
        if "dur" not in e or str(e.get("cat", "")) not in ("kernel", "gpu_memcpy",
                                                            "gpu_memset"):
            continue
        name = str(e.get("name", ""))
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if any(sym in name for sym in KERNEL_SYMBOLS["fused_generalized_linear_attention"]):
            group = "favor"
        elif any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "cublas")):
            group = "gemm"
        else:
            group = "other"
        out[group] += float(e["dur"]) / 1e3
    out["busy"] = sum(b - a for a, b in merged(spans)) / 1e3
    return out


def phase_pretrain(torch, card, tmp, dirs, dev) -> dict:
    """Phase 16: ``pretrain-scbert`` at full width on phase 15's array 0,
    one MLM step kernel route against plain route, fine-tuning from the
    checkpoint, and ``train-graph`` over phase 15's cohort."""
    import argparse
    import io as stdio

    from torch.profiler import ProfilerActivity, profile

    from gridnext_tpu_torch import cli, geometry, modeldir, models, serving
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.data import graph_data
    from gridnext_tpu_torch.io import read_positions
    from gridnext_tpu_torch.models import performer
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.train import loops as tl

    t_phase = time.perf_counter()
    out, laps = {}, {}
    n_tokens = MM_VOCAB + 1
    log(f"== phase 16: pretrain-scbert at full width (dim {MM_DIM}, depth {MM_DEPTH}, "
        f"heads {MM_HEADS}, dim_head {MM_DIM_HEAD}, N {n_tokens}, batch {PRETRAIN_BATCH}, "
        f"--redraw-every {PRETRAIN_REDRAW}), an MLM step kernel vs plain, fine-tuning from "
        f"its checkpoint, train-graph over {len(dirs)} arrays (TF32 off)")
    torch.cuda.reset_peak_memory_stats()

    # (a) the pretrain-scbert command, its steps and redraws recorded
    rec = {"train": [], "eval": 0, "redraws": [], "state": None, "t_train": None,
           "t_eval": None, "y0": None}
    make_mlm, redraw = tl.make_mlm_steps, performer.redraw_projections

    def recording_steps(state, **kw):
        train_step, eval_step = make_mlm(state, **kw)
        rec["state"] = state

        def train(x, y):
            if rec["t_train"] is None:
                torch.cuda.synchronize()
                rec["t_train"], rec["y0"] = time.perf_counter(), y.clone()
            m = train_step(x, y)
            rec["train"].append(m["loss"])
            return m

        def evaluate(x, y):
            if rec["t_eval"] is None:
                torch.cuda.synchronize()
                rec["t_eval"] = time.perf_counter()
            rec["eval"] += 1
            return eval_step(x, y)

        return train, evaluate

    def recording_redraw(model, generator):
        before = [fa.projection.clone() for fa in performer.fast_attentions(model)]
        n = redraw(model, generator)
        after = performer.fast_attentions(model)
        rec["redraws"].append(n == MM_DEPTH and len(before) == n and all(
            not torch.equal(b, fa.projection) for b, fa in zip(before, after)))
        return n

    lm_dir = os.path.join(tmp, "pretrain")
    tl.make_mlm_steps, performer.redraw_projections = recording_steps, recording_redraw
    try:
        torch.cuda.synchronize()
        favor_cuda.launches = 0
        t0 = time.perf_counter()
        cli.main(["pretrain-scbert", "--spaceranger", dirs[0], "--out", lm_dir, "--epochs", "1",
                  "--batch-size", str(PRETRAIN_BATCH), "--redraw-every", str(PRETRAIN_REDRAW),
                  "--scbert-vocab", str(MM_VOCAB), "--scbert-dim", str(MM_DIM),
                  "--scbert-depth", str(MM_DEPTH), "--scbert-heads", str(MM_HEADS),
                  "--scbert-dim-head", str(MM_DIM_HEAD), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = favor_cuda.launches
    finally:
        tl.make_mlm_steps, performer.redraw_projections = make_mlm, redraw
    t_end = time.perf_counter()
    losses = np.asarray([float(v) for v in rec["train"]])
    n_train, n_eval = len(losses), rec["eval"]
    want = MM_DEPTH * (n_train + n_eval)
    t_train = rec["t_eval"] - rec["t_train"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    out["pretrain"] = {"wall_s": wall, "train_steps": n_train, "val_steps": n_eval,
                       "favor_launches": launches, "redraws": len(rec["redraws"]),
                       "train_s": t_train, "epoch_s": t_end - rec["t_train"],
                       "steps_per_s": n_train / t_train,
                       "tokens_per_s": n_train * PRETRAIN_BATCH * n_tokens / t_train,
                       "loss_first20": first, "loss_last20": last, "peak_gib": peak}
    log(f"(a) pretrain-scbert: {wall:.2f} s with the corpus build, {n_train} train steps in "
        f"{t_train:.2f} s ({n_train / t_train:.3f} steps/s, "
        f"{n_train * PRETRAIN_BATCH * n_tokens / t_train:.0f} tokens/s), epoch (train + "
        f"{n_eval} val steps + checkpoints) {t_end - rec['t_train']:.2f} s; {launches} FAVOR "
        f"wrapper calls ({want} expected: {MM_DEPTH} a forward, no remat); "
        f"{len(rec['redraws'])} redraws; mean loss of the first 20 steps {first:.4f}, of the "
        f"last 20 {last:.4f}; peak device memory {peak:.2f} GiB [{card}]")
    if launches != want:
        raise AssertionError(f"pretrain-scbert: {launches} FAVOR calls, want {want}")
    if len(rec["redraws"]) != n_train // PRETRAIN_REDRAW or len(rec["redraws"]) < 2 \
            or not all(rec["redraws"]):
        raise AssertionError(f"pretrain-scbert: redraws {rec['redraws']} over {n_train} steps")
    if not last < first:
        raise AssertionError(f"pretrain-scbert: the loss did not fall ({first} -> {last})")
    lm = rec["state"].model
    path = os.path.join(lm_dir, "scbert_lm.msgpack")
    loaded = cli._load_scbert_ckpt(path, MM_DEPTH)
    held = from_jax.jax_variables(lm)
    n_leaves = 0
    for coll, tree in held.items():
        for leaf_path, a in tree_leaves(tree):
            b = loaded[coll]["performer_lm"]
            for k in leaf_path:
                b = b[k]
            if not np.array_equal(a, b):
                raise AssertionError(f"scbert_lm.msgpack: {coll}/{'/'.join(leaf_path)} does "
                                     "not read back bit-equal")
            n_leaves += 1
    log(f"(a) scbert_lm.msgpack ({os.path.getsize(path) / 1e6:.1f} MB): {n_leaves} leaves read "
        f"back bit-equal through _load_scbert_ckpt [{card}]")
    laps["(a)"] = time.perf_counter()

    # (b) one MLM step, kernel route against plain route, on a batch of (a)'s
    # corpus. The weights come from a numpy seed (random_variables: unit-normal
    # token embeddings): on (a)'s weights the attention near-averages the
    # tokens and the q/k/v gradients are mostly float noise (PERF.md §7)
    y = rec["y0"]
    mask = tl._mlm_mask(torch.Generator(device=dev).manual_seed(SEED + 30), y.shape, 0.15, dev)
    tokens = torch.where(mask, torch.full_like(y, 6), y.clamp_min(0)).long()
    lm_b = models.PerformerLM(num_tokens=7, max_seq_len=n_tokens, dim=MM_DIM, depth=MM_DEPTH,
                              heads=MM_HEADS, dim_head=MM_DIM_HEAD, generalized_attention=True)
    from_jax.load_variables(lm_b, random_variables(models, from_jax, seed=SEED + 32,
                                                   model=lm_b))
    lm_b.to(dev).train()
    res = favor_gradient_gate(
        torch, lm_b, lambda: tl.mlm_loss(lm_b(tokens), y, mask)[0], dev,
        f"(b) one MLM step's q/k/v projection gradients over {MM_DEPTH} FAVOR calls at "
        f"({PRETRAIN_BATCH}, {MM_HEADS}, {n_tokens}, {MM_DIM_HEAD})", MM_DEPTH)
    g_kernel = res.pop("grads")
    rel_loss = abs(res["loss_kernel"] - res["loss_plain"]) / abs(res["loss_plain"])
    log(f"(b) MLM loss kernel route {res['loss_kernel']:.6f}, plain route "
        f"{res['loss_plain']:.6f}: relative difference {rel_loss:.3g} (<= 1e-4) [{card}]")
    if not rel_loss <= 1e-4:
        raise AssertionError(f"the MLM loss differs by {rel_loss} between the routes")
    # the same step under --remat: each block's forward runs again in the
    # backward, FAVOR's wrapper with it (2 calls a layer), and the
    # recomputation must give the kernel route's gradients without remat
    lm_b.performer.remat = True
    lm_b.zero_grad(set_to_none=True)
    favor_cuda.launches = 0
    tl.mlm_loss(lm_b(tokens), y, mask)[0].backward()
    remat_launches = favor_cuda.launches
    lm_b.performer.remat = False
    grads = dict(lm_b.named_parameters())
    remat_gap = max(float((grads[n].grad - g).norm() / g.norm()) for n, g in g_kernel.items())
    bit_equal = all(torch.equal(grads[n].grad, g) for n, g in g_kernel.items())
    log(f"(b) the step under remat: {remat_launches} FAVOR calls ({2 * MM_DEPTH} expected: "
        f"{MM_DEPTH} layers x 2, the forward and its recomputation); q/k/v projection "
        f"gradients against the kernel route without remat: max relative gap {remat_gap:.3g} "
        f"(<= 1e-6), bit-equal {bit_equal} [{card}]")
    if remat_launches != 2 * MM_DEPTH or not remat_gap <= 1e-6:
        raise AssertionError(f"remat: {remat_launches} FAVOR calls, gradients {remat_gap} "
                             "from the step without remat")
    out["mlm_step"] = {**res, "loss_rel": rel_loss, "remat_launches": remat_launches,
                       "remat_gap": remat_gap, "remat_bit_equal": bit_equal}
    del g_kernel, grads
    lm_b.zero_grad(set_to_none=True)
    # the same readings on (a)'s pretrained weights, held to nothing: there
    # the kernel's median sits at the tolerance's (PERF.md §7)
    lm.train()
    pre = favor_gradient_readings(torch, lm, lambda: tl.mlm_loss(lm(tokens), y, mask)[0], dev,
                                  MM_DEPTH)
    del pre["grads"]
    lm.zero_grad(set_to_none=True)
    log(f"(b) the same step on (a)'s pretrained weights (a reading, not a gate): median gap "
        f"{pre['gap']:.3g}, the tolerance's {pre['limit']:.3g}, the planted fault's "
        f"{pre['planted']:.3g}; worst projection {pre['worst']:.3g} (planted "
        f"{pre['planted_worst']:.3g}) [{card}]")
    out["mlm_step_pretrained"] = pre
    # a traced window of MLM steps: the device's busy time and its split
    state = tl.create_train_state(lm, tl.make_adam(1e-4), device=dev, init=False)
    step, _ = tl.make_mlm_steps(state, mask_id=6)
    x = torch.zeros((PRETRAIN_BATCH, 1), dtype=torch.int8, device=dev)
    step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PRETRAIN_TRACE_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        t_traced = (time.perf_counter() - t0) * 1e3 / PRETRAIN_TRACE_STEPS
    trace = os.path.join(tmp, "pretrain_trace.json")
    prof.export_chrome_trace(trace)
    split = {k: v / PRETRAIN_TRACE_STEPS for k, v in device_ms_by_kernel(trace).items()}
    step_ms = t_train * 1e3 / n_train
    out["mlm_trace"] = {**split, "traced_step_ms": t_traced, "untraced_step_ms": step_ms,
                        "idle_share": 1 - split["busy"] / step_ms}
    log(f"(b) traced MLM steps ({PRETRAIN_TRACE_STEPS}): device ms a step: FAVOR kernels "
        f"{split['favor']:.2f}, GEMM {split['gemm']:.2f}, other {split['other']:.2f}, busy "
        f"{split['busy']:.2f}; (a)'s untraced step {step_ms:.2f} ms: device idle share "
        f"{1 - split['busy'] / step_ms:.3f} ({1 - split['busy'] / t_traced:.3f} against the "
        f"traced {t_traced:.2f} ms a step) [{card}]")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    del state, step, prof, lm, lm_b, rec
    laps["(b)"] = time.perf_counter()

    # (c) fine-tuning from (a)'s checkpoint: the command's start, one
    # --scbert-finetune spot step (phase 14 (c) runs before (a) exists)
    sc = models.scBERT(n_genes=MM_VOCAB, dim=MM_DIM, depth=MM_DEPTH, heads=MM_HEADS,
                       dim_head=MM_DIM_HEAD, n_classes=N_CLASSES, generalized_attention=True)
    args = argparse.Namespace(scbert_ckpt=path, scbert_finetune=True, scbert_depth=MM_DEPTH,
                              f_lr=FINETUNE_LR, device=dev)
    printed = stdio.StringIO()
    with contextlib.redirect_stdout(printed):
        state, frozen_f = cli._scbert_start(args, sc)
    report = printed.getvalue().strip()
    log(f"(c) {report}")
    if "1 entries re-initialized" not in report or "'/to_out (missing)'" not in report \
            or frozen_f is None:
        raise AssertionError(f"fine-tuning start: {report}")
    mine = from_jax.jax_variables(sc)
    for coll, tree in loaded.items():
        for leaf_path, a in tree_leaves(tree):
            if leaf_path[:2] == ("performer_lm", "to_out"):
                continue                  # the LM's own token head: scBERT has none
            b = mine[coll]
            for k in leaf_path:
                b = b[k]
            if not np.array_equal(a, b):
                raise AssertionError(f"fine-tuning start: {coll}/{'/'.join(leaf_path)} is not "
                                     "the checkpoint's")
    rng = np.random.default_rng(SEED + 31)
    xb = torch.as_tensor(np.minimum(rng.poisson(0.4, (SCBERT_BATCH, MM_VOCAB)), 7)
                         .astype(np.float32), device=dev)
    yb = torch.as_tensor(rng.integers(0, N_CLASSES, SCBERT_BATCH), device=dev)
    centre_head(torch, sc, xb)
    entries = [(p[1:], t) for p, t, _ in from_jax.model_entries(sc) if p[0] == "params"]
    before = {p: t.detach().clone() for p, t in entries}
    labels = state.optimizer.labels
    train_step, _ = tl.make_steps(state, "spot")
    favor_cuda.launches = 0
    m = train_step(xb, yb)
    step_launches = favor_cuda.launches
    frozen = [p for p in before if labels[p] == "frozen"]
    trained = [p for p in before if labels[p] == "train"]
    changed = {p for p, t in entries if not torch.equal(t.detach(), before[p])}
    log(f"(c) one --scbert-finetune spot step (batch {SCBERT_BATCH}): loss "
        f"{float(m['loss']):.4f}, {step_launches} FAVOR calls; {len(frozen)} frozen leaves "
        f"bit-unchanged: {not (changed & set(frozen))}, {len(trained)} train leaves moved: "
        f"{len(changed & set(trained))} [{card}]")
    if changed & set(frozen):
        raise AssertionError(f"frozen leaves moved: {sorted(changed & set(frozen))[:3]}")
    if set(trained) - changed or not trained or step_launches != MM_DEPTH:
        raise AssertionError(f"train leaves that did not move: "
                             f"{sorted(set(trained) - changed)[:3]}; {step_launches} calls")
    del sc, state, before, loaded, mine
    laps["(c)"] = time.perf_counter()

    # (d) train-graph over the cohort, then register array 0 through its directory
    annots = [os.path.join(d, f"a{i}_annotations.csv") for i, d in enumerate(dirs)]
    gdir = os.path.join(tmp, "model_graph")
    graph = {}
    fit = cli.fit_graph

    def recorded_fit(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(*a, **kw)
        torch.cuda.synchronize()
        graph["fit_s"] = time.perf_counter() - t0
        graph["losses"] = [float(v) for v in res]
        return res

    cli.fit_graph = recorded_fit
    try:
        t0 = time.perf_counter()
        cli.main(["train-graph", "--spaceranger", *dirs, "--annots", *annots, "--out", gdir,
                  "--device", str(dev)])
        graph_wall = time.perf_counter() - t0
    finally:
        cli.fit_graph = fit
    gl = graph["losses"]
    csv_out = os.path.join(tmp, "graph0.csv")
    cli.main(["register", "--model", gdir, "--spaceranger", dirs[0], "--out", csv_out,
              "--device", str(dev)])
    meta, classes, variables = from_jax.load_model_dir(gdir)
    net = modeldir.graph_model_from_meta(meta, classes, variables, device=dev)
    gd = graph_data.visium_to_graphdata([dirs[0]])
    with torch.no_grad():
        node_logits = net(torch.as_tensor(np.log1p(gd["nodes"]), device=dev),
                          torch.as_tensor(gd["edges"], device=dev)).cpu().numpy()
    shape = (geometry.VISIUM_H_ST, geometry.VISIUM_W_ST)
    ox, oy = geometry.pseudo_hex_to_oddr(gd["pos"][:, 0], gd["pos"][:, 1])
    logits = np.zeros(shape + (len(classes),), np.float32)
    logits[oy, ox] = node_logits
    want_grid = np.zeros(shape, np.int64)
    want_grid[oy, ox] = node_logits.argmax(-1) + 1
    got, n_rows = csv_label_grid(csv_out, read_positions(dirs[0]), list(classes), shape)
    if n_rows != gd["nodes"].shape[0] or not np.array_equal(got > 0, want_grid > 0):
        raise AssertionError(f"train-graph register: {n_rows} CSV rows for "
                             f"{gd['nodes'].shape[0]} nodes")
    flips = serving.label_parity_report(want_grid, got, logits)
    out["train_graph"] = {"wall_s": graph_wall, "fit_s": graph["fit_s"],
                          "steps_per_s": GRAPH_STEPS / graph["fit_s"], "loss_first": gl[0],
                          "loss_last": gl[-1], "flips": flips}
    log(f"(d) train-graph ({GRAPH_STEPS} steps, hidden 64, depth 3): {graph_wall:.2f} s with "
        f"the graph build, fit {graph['fit_s']:.2f} s ({GRAPH_STEPS / graph['fit_s']:.1f} "
        f"steps/s), loss {gl[0]:.4f} -> {gl[-1]:.4f}; register of array 0: the CSV names a "
        f"direct forward's labels up to {flips} near-tie flips of {n_rows} nodes [{card}]")
    if not (len(gl) == GRAPH_STEPS and np.mean(gl[-20:]) < np.mean(gl[:20])):
        raise AssertionError(f"train-graph: the loss did not fall ({gl[0]} -> {gl[-1]})")
    laps["(d)"] = time.perf_counter()
    prev, parts = t_phase, []
    for name, t in laps.items():
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['phase_s']:.1f} s ({', '.join(parts)} s) [{card}]")
    log(json.dumps({"phase16": out}))
    return out


# -- phase 17: the evaluate and distill commands ------------------------------------

DISTILL_STEPS = 200           # (b)'s distill --steps (default 2,000; cut)
MM_DISTILL_STEPS, MM_DISTILL_BATCH = 50, 64   # (c)'s --steps / --batch-size (2,000 / 256; cut)
DISTILL_BATCH = 256           # distill's default --batch-size (also its scBERT holdout chunk)


def tree_equal(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and sorted(a) == sorted(b)
                and all(tree_equal(a[k], b[k]) for k in a))
    return np.array_equal(np.asarray(a), np.asarray(b))


def favor_float64(q, k, v, proj):
    """The plain ReLU-FAVOR attention (``favor_attention_plain``'s steps)
    in float64: the exact value both float32 routes are held to."""
    from gridnext_tpu_torch.ops.favor import generalized_kernel_features

    q, k, v, proj = (t.double() for t in (q, k, v, proj))
    qf = generalized_kernel_features(q, proj)
    kf = generalized_kernel_features(k, proj)
    d_inv = 1.0 / (qf * kf.sum(dim=-2)[..., None, :]).sum(-1)
    return (qf @ (kf.transpose(-1, -2) @ v)) * d_inv[..., None]


def teacher_routes(torch, performer, favor_cuda, teacher, pool, card) -> dict:
    """(c)'s scBERT teacher on its own pool, where the distill command runs
    it: a ``MM_DISTILL_BATCH``-row chunk through the FAVOR kernel and its
    plain version (the logits within 1e-3, as phase 9's count chunks; the
    first layer's attention within FAVOR's tolerance of its float64 value
    on the 8 sequences where the kernel departs most from the float32
    plain version, that departure a reading), then a ``DISTILL_BATCH``-row
    chunk through the kernel: its time, its peak device memory and its
    first rows against the plain route, or the out-of-memory error it
    raised."""
    kernel, first = performer.fused_generalized_linear_attention, {}

    def first_call(q, k, v, proj):
        out = kernel(q, k, v, proj)
        if not first:
            first.update(q=q, k=k, v=v, proj=proj, out=out)
        return out

    torch.cuda.empty_cache()
    performer.fused_generalized_linear_attention = first_call
    try:
        got, want = count_f_routes(torch, teacher, pool[:MM_DISTILL_BATCH], MM_STEP_DEPTH)
    finally:
        performer.fused_generalized_linear_attention = kernel
    q, k, v, proj, out = (first.pop(n) for n in ("q", "k", "v", "proj", "out"))
    plain = favor_cuda.favor_attention_plain(q, k, v, proj)
    diff = (out - plain).abs()
    gap = diff / (FAVOR_ATOL + FAVOR_RTOL * plain.abs())
    seqs = gap.flatten(1).amax(1).topk(min(8, len(gap))).indices
    exact = favor_float64(q[seqs], k[seqs], v[seqs], proj)

    def vs_exact(x):
        return float(((x[seqs].double() - exact).abs()
                      / (FAVOR_ATOL + FAVOR_RTOL * exact.abs())).max().item())

    res = {"attention_max_abs_err": float(diff.max().item()),
           "attention_worst": float(gap.max().item()),
           "kernel_vs_float64": vs_exact(out), "plain_vs_float64": vs_exact(plain),
           "scale": float(exact.abs().max().item()),
           "logits_max_abs_err": float((got - want).abs().max().item()),
           "logits_spread": float((want.amax(0) - want.amin(0)).max().item())}
    shape = tuple(q.shape)
    del q, k, v, out, plain, diff, gap, exact, got
    if not (res["kernel_vs_float64"] <= 1.0 and res["logits_max_abs_err"] <= 1e-3
            and res["logits_spread"] > 1e-2):
        raise AssertionError(f"(c): the teacher's kernel route against its plain route "
                             f"at {shape}: {res}")
    log(f"(c) the teacher on {MM_DISTILL_BATCH} rows of its pool, kernel vs plain route: "
        f"first layer's attention at {shape} (largest |value| {res['scale']:.3g}): against "
        f"float64 on the 8 sequences farthest apart, kernel {res['kernel_vs_float64']:.3g} x, "
        f"float32 plain {res['plain_vs_float64']:.3g} x FAVOR's tolerance (rtol {FAVOR_RTOL}, "
        f"atol {FAVOR_ATOL}; <= 1 for the kernel); kernel vs float32 plain max abs err "
        f"{res['attention_max_abs_err']:.3g}, {res['attention_worst']:.3g} x the tolerance; "
        f"logits max abs err {res['logits_max_abs_err']:.3g} (<= 1e-3; spread across the "
        f"rows {res['logits_spread']:.3g}) [{card}]")

    rows = min(DISTILL_BATCH, len(pool))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            big = teacher(pool[:rows])
        torch.cuda.synchronize()
        res.update(big_rows=rows, big_s=time.perf_counter() - t0,
                   big_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   resident_gib=resident,
                   big_max_abs_err=float((big[:len(want)] - want).abs().max().item()))
        del big
    except torch.cuda.OutOfMemoryError as e:
        res.update(big_rows=rows, big_oom=str(e).splitlines()[0], resident_gib=resident)
        log(f"(c) the teacher on {rows} rows (distill's default --batch-size): out of device "
            f"memory with {resident:.2f} GiB resident before it: {res['big_oom']} [{card}]")
        return res
    if not res["big_max_abs_err"] <= 1e-3:
        raise AssertionError(f"(c): the teacher's first {len(want)} of {rows} rows differ "
                             f"from the plain route by {res['big_max_abs_err']}")
    log(f"(c) the teacher on {rows} rows (distill's default --batch-size, its holdout chunk): "
        f"{res['big_s']:.3f} s, peak device memory {res['big_peak_gib']:.2f} GiB "
        f"({resident:.2f} GiB resident before it); its first {len(want)} rows within "
        f"{res['big_max_abs_err']:.3g} of the plain route's (<= 1e-3) [{card}]")
    return res


def phase_eval_distill(torch, port, card, tmp, cohort, mm, dev) -> dict:
    """Phase 17 (module docstring) in phase 14's cohort and directory, the
    slides ``.npy`` files (decode swapped for np.load). Returns each
    kernel's launches on the evaluate and the distill commands' paths."""
    from gridnext_tpu_torch import ingest

    decode = ingest.decode_slide
    ingest.decode_slide = np.load
    try:
        return eval_distill_phase(torch, port, card, tmp, cohort, mm, dev)
    finally:
        ingest.decode_slide = decode


def eval_distill_phase(torch, port, card, tmp, cohort, mm, dev) -> dict:
    from gridnext_tpu_torch import cli
    from gridnext_tpu_torch.data.datasets import to_device_slide
    from gridnext_tpu_torch.io.unify import unified_cache_path
    from gridnext_tpu_torch.models import gridnet, performer
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.train import distill

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    dirs, npys, csvs, masks, truth, model_dir = (cohort[k] for k in (
        "dirs", "npys", "csvs", "masks", "truth", "model"))
    classes = [f"Class_{i + 1}" for i in range(N_CLASSES)]
    n_spots = [int(m.sum()) for m in masks]
    kernels = ("gather_patches", "fused_hex_corrector", "fused_hex_corrector_labels",
               "fused_generalized_linear_attention")
    totals = {"evaluate": dict.fromkeys(kernels, 0), "distill": dict.fromkeys(kernels, 0)}
    t_phase = time.perf_counter()
    laps = {}
    log(f"== phase 17: the evaluate and distill commands over phase 14's cohort "
        f"({len(dirs)} arrays, {sum(n_spots)} annotated spots) and trained DenseNet-121 "
        f"directory (TF32 off)")

    def counted(argv):
        """``cli.main(argv)`` with the counts of the gather, the corrector and
        FAVOR set to 0 just before and read just after (added to the
        command's totals): (result, wall s, launches)."""
        torch.cuda.synchronize()
        gather.launches = favor_cuda.launches = 0
        for k in corr.launches:
            corr.launches[k] = 0
        t0 = time.perf_counter()
        res = cli.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"gather_patches": gather.launches, **corr.launches,
               "fused_generalized_linear_attention": favor_cuda.launches}
        for k in kernels:
            if argv[0] in totals:
                totals[argv[0]][k] += got[k]
        return res, wall, got

    def check(name, got, want):
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")

    f_calls, eval_labels = [], []
    patch_predictions = gridnet._GridNetBase.patch_predictions
    fgd_predictions = evaluate.all_fgd_predictions

    def counted_f(self, x):
        f_calls.append(1)
        return patch_predictions(self, x)

    def kept_labels(*args, **kwargs):
        """``all_fgd_predictions``, keeping each array's truth grid and
        evaluate's own labels (its foreground argmax) as a grid."""
        out = fgd_predictions(*args, **kwargs)
        y_true, y_pred, _, grids = out
        (y_grid, _), = grids
        pred = np.zeros(y_grid.shape, np.int64)
        pred.reshape(-1)[y_grid.reshape(-1) > 0] = y_pred + 1
        eval_labels.append((y_grid, pred))
        return out

    gridnet._GridNetBase.patch_predictions = counted_f
    evaluate.all_fgd_predictions = kept_labels
    try:
        # (a) evaluate over the 4 arrays, then --tta and --f-only on one each
        base = ["--spaceranger", *dirs, "--annots", *csvs, "--images", *npys]
        f_calls.clear()
        m_a, wall, got = counted(["evaluate", "--model", model_dir, *base,
                                  "--out", os.path.join(tmp, "eval_a.json")])
        check("(a) evaluate", got, {"gather_patches": len(dirs), "fused_hex_corrector_labels": 0,
                                    "fused_generalized_linear_attention": 0})
        if len(f_calls) != len(dirs) or len(eval_labels) != len(dirs):
            raise AssertionError(f"(a): f ran {len(f_calls)} times, all_fgd_predictions "
                                 f"{len(eval_labels)} times over {len(dirs)} arrays")
        # evaluate's labels against the registrar's on the same slides
        meta, classes_m, variables = from_jax.load_model_dir(model_dir)
        reg = modeldir.image_registrar_from_meta(meta, classes_m, variables, device=dev)
        correct = n_right = flips = 0
        for i, (npy, srd, mask, tr, (y_grid, pred)) in enumerate(
                zip(npys, dirs, masks, truth, eval_labels)):
            fg = mask > 0
            if not np.array_equal(y_grid, tr):
                raise AssertionError(f"(a): evaluate's truth grid of array {i} differs from "
                                     f"the annotations")
            wsi = to_device_slide(np.load(npy), dev)
            pos = io.read_positions(srd)
            labels = reg(wsi, pos)
            logits, _ = reg.register_logits(wsi, pos)
            del wsi
            flips += serving.label_parity_report(np.where(fg, labels, 0), pred, logits)
            correct += int((labels[fg] == tr[fg]).sum())
            n_right += int((pred[fg] == tr[fg]).sum())
        n_fg = sum(n_spots)
        if m_a["n_foreground_spots"] != n_fg or abs(m_a["accuracy"] - n_right / n_fg) > 1e-12:
            raise AssertionError(f"(a): evaluate's accuracy {m_a['accuracy']} over "
                                 f"{m_a['n_foreground_spots']} spots; its labels' "
                                 f"{n_right / n_fg} over {n_fg}")
        log(f"(a) evaluate over {len(dirs)} arrays ({n_fg} spots): {wall:.2f} s, "
            f"{wall / len(dirs):.2f} s per array, accuracy {m_a['accuracy']:.4f}; its labels "
            f"equal to the registrar's up to {flips} near-tie flips (the registrar's accuracy "
            f"{correct / n_fg:.4f}), macro AUROC {m_a['macro_auroc']:.4f}, macro AUPRC "
            f"{m_a['macro_auprc']:.4f}; launches {json.dumps(got)} [{card}]")
        one = ["--spaceranger", dirs[0], "--annots", csvs[0], "--images", npys[0]]
        walls = {}
        for flag, want_f in (("--tta", 8), ("--f-only", 1)):
            f_calls.clear()
            m, walls[flag], got = counted(["evaluate", "--model", model_dir, *one, flag,
                                           "--out", os.path.join(tmp, f"eval{flag}.json")])
            check(f"(a) {flag}", got, {"gather_patches": 1})
            if len(f_calls) != want_f:
                raise AssertionError(f"(a) {flag}: f ran {len(f_calls)} times, want {want_f}")
            log(f"(a) evaluate {flag} of array 0 ({n_spots[0]} spots): {walls[flag]:.2f} s, "
                f"f run {len(f_calls)} times, accuracy {m['accuracy']:.4f} [{card}]")
    finally:
        gridnet._GridNetBase.patch_predictions = patch_predictions
        evaluate.all_fgd_predictions = fgd_predictions
    laps["(a)"] = time.perf_counter()

    # (b) distill the trained directory into the default bf16 student
    timed = {}
    loop = distill.distill_patch_classifier

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop(*args, **kwargs)
        torch.cuda.synchronize()
        timed.update(s=time.perf_counter() - t0, losses=out[1], steps=kwargs["steps"],
                     batch=kwargs["batch_size"], pool=len(args[2]), teacher=args[0],
                     teacher_inputs=kwargs.get("teacher_inputs"))
        return out

    student_dir = os.path.join(tmp, "model_distilled")
    distill.distill_patch_classifier = timed_loop
    try:
        info, wall, got = counted(["distill", "--model", model_dir, "--spaceranger", *dirs,
                                   "--images", *npys, "--out", student_dir,
                                   "--steps", str(DISTILL_STEPS)])
    finally:
        distill.distill_patch_classifier = loop
    check("(b) distill", got, {"gather_patches": 1 + 2 * len(dirs),
                               "fused_hex_corrector_labels": 2 * len(dirs)})
    losses = timed["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(b): the distillation loss did not fall: {losses}")
    s_meta, s_classes, s_vars = from_jax.load_model_dir(student_dir)
    reg_s = modeldir.image_registrar_from_meta(s_meta, s_classes, s_vars, device=dev)
    agrs, student_labels = [], []
    for npy, srd in zip(npys, dirs):
        wsi = to_device_slide(np.load(npy), dev)
        pos = io.read_positions(srd)
        labels_s = reg_s(wsi, pos)
        agrs.append(distill.label_agreement(reg(wsi, pos), labels_s))
        student_labels.append((labels_s, reg_s.register_logits(wsi, pos)[0]))
        del wsi
    if abs(float(np.mean(agrs)) - info["label_agreement"]) > 1e-12:
        raise AssertionError(f"(b): recorded label agreement {info['label_agreement']}, "
                             f"the registrars' {float(np.mean(agrs))}")
    rate = timed["steps"] / timed["s"]
    log(f"(b) distill {meta['model']} -> {s_meta['model']} (bf16, stages "
        f"{s_meta['tpu_f']['stages']}): {wall:.2f} s; the loop {timed['s']:.2f} s over "
        f"{timed['pool']} patches, {rate:.2f} steps/s, {rate * timed['batch']:.1f} patches/s "
        f"at batch {timed['batch']}; chunk losses {[round(v, 5) for v in losses]}; holdout "
        f"patch agreement {info['patch_agreement']:.4f}, label agreement "
        f"{info['label_agreement']:.4f} (per array {[round(a, 4) for a in agrs]}, equal to "
        f"the registrars'); launches {json.dumps(got)} [{card}]")
    # register reads the student directory; evaluate scores both (consensus)
    out_csv = os.path.join(tmp, "distilled_csv")
    counted(["register", "--model", student_dir, "--spaceranger", *dirs, "--images", *npys,
             "--out", out_csv])
    flips = 0
    for i, (mask, (labels_s, logits_s)) in enumerate(zip(masks, student_labels)):
        grid, n_rows = loupe_grid(os.path.join(out_csv, f"slide{i}_loupe.csv"), mask.shape,
                                  classes)
        if n_rows != n_spots[i]:
            raise AssertionError(f"(b) register: {n_rows} rows for {n_spots[i]} spots")
        flips += serving.label_parity_report(labels_s, grid, logits_s)
    m_b, wall, got = counted(["evaluate", "--model", model_dir, student_dir, *base,
                              "--out", os.path.join(tmp, "eval_b.json")])
    check("(b) evaluate", got, {"gather_patches": 2 * len(dirs)})
    log(f"(b) register of the student directory: the CSVs name its registrar's labels up to "
        f"{flips} near-tie flips; evaluate of teacher + student: {wall:.2f} s, accuracy "
        f"teacher {m_b['models'][model_dir]['accuracy']:.4f}, student "
        f"{m_b['models'][student_dir]['accuracy']:.4f}, consensus "
        f"{m_b['consensus']['accuracy']:.4f} [{card}]")
    laps["(b)"] = time.perf_counter()

    # (c) an scBERT + DenseNet-121 multimodal directory (phase 13 (a)'s: its
    # scBERT cut to MM_STEP_DEPTH layers) over array 0's 16,906-gene cache
    srd = dirs[0]
    pos = io.read_positions(srd)
    keep = pos["in_tissue"] == 1
    y, x = np.divmod(np.flatnonzero(keep), geometry.VISIUM_W_ST)
    ids = [f"ENSG{i:011d}" for i in range(MM_VOCAB)]
    counts = mm["raw"][y, x].T.astype(np.int64)                # (genes, spots)
    write_unified_cache(unified_cache_path(srd), ids,
                        [f"{c}_{r}" for c, r in zip(pos["array_col"][keep],
                                                    pos["array_row"][keep])], counts)
    write_mex(os.path.join(srd, "outs", "filtered_feature_bc_matrix"), ids,
              load_gene2vec_names()[:MM_VOCAB], [b for b, k in zip(pos.barcodes, keep) if k],
              counts)
    meta_c = {**mm["meta"], "genes": ids, "n_genes": MM_VOCAB, "scbert_depth": MM_STEP_DEPTH}
    vars_c = scbert_depth_cut(mm["variables"], MM_STEP_DEPTH)
    dir_c = os.path.join(tmp, "model_mm_scbert")
    from_jax.save_model_dir(dir_c, meta_c, vars_c)
    student_c = os.path.join(tmp, "model_mm_distilled")
    timed.clear()
    distill.distill_patch_classifier = timed_loop
    try:
        info_c, wall, got = counted(["distill", "--model", dir_c, "--spaceranger", srd,
                                     "--out", student_c, "--steps", str(MM_DISTILL_STEPS),
                                     "--batch-size", str(MM_DISTILL_BATCH)])
    finally:
        distill.distill_patch_classifier = loop
    n_items = int(keep.sum())
    n_hold = max(1, int(n_items * 0.15))
    forwards = MM_DISTILL_STEPS + -(-n_hold // MM_DISTILL_BATCH)   # the holdout by batches
    check("(c) distill", got, {"gather_patches": 0,
                               "fused_generalized_linear_attention": MM_STEP_DEPTH * forwards})
    c_meta, _, c_vars = from_jax.load_model_dir(student_c)
    if c_meta["count_f"] != "mlp" or "favor" in c_vars:
        raise AssertionError(f"(c): count_f {c_meta['count_f']}, collections {sorted(c_vars)}")
    for coll in ("params", "batch_stats"):
        for key in ("image_classifier", "corrector"):
            if not tree_equal(c_vars[coll][key], vars_c[coll][key]):
                raise AssertionError(f"(c): {coll}/{key} differs from the teacher's")
    log(f"(c) distill scBERT (depth {MM_STEP_DEPTH}, {MM_VOCAB} genes) -> CountMLP over "
        f"{n_items} spots ({n_hold} held out): {wall:.2f} s, the loop {timed['s']:.2f} s "
        f"({MM_DISTILL_STEPS / timed['s']:.2f} steps/s at batch {MM_DISTILL_BATCH}), "
        f"chunk losses {[round(v, 5) for v in timed['losses']]}, count-f agreement "
        f"{info_c['count_f_agreement']:.4f}; {got['fused_generalized_linear_attention']} FAVOR "
        f"calls = {MM_STEP_DEPTH} x {forwards} teacher forwards; image f and corrector "
        f"bit-equal to the teacher's [{card}]")
    teacher_c = teacher_routes(torch, performer, favor_cuda, timed["teacher"],
                               timed["teacher_inputs"], card)
    timed.pop("teacher"), timed.pop("teacher_inputs")
    m_c, wall, got = counted(["evaluate", "--model", dir_c, student_c, "--spaceranger", srd,
                              "--annots", csvs[0], "--images", npys[0],
                              "--out", os.path.join(tmp, "eval_c.json")])
    want_favor = -(-geometry.VISIUM_H_ST * geometry.VISIUM_W_ST // COUNT_CHUNK) * MM_STEP_DEPTH
    check("(c) evaluate", got, {"gather_patches": 2,
                                "fused_generalized_linear_attention": want_favor})
    log(f"(c) evaluate of the multimodal teacher + student over array 0: {wall:.2f} s, "
        f"accuracy teacher {m_c['models'][dir_c]['accuracy']:.4f}, student "
        f"{m_c['models'][student_c]['accuracy']:.4f}; launches {json.dumps(got)} [{card}]")
    laps["(c)"] = time.perf_counter()
    prev, parts = t_phase, []
    for name, t in laps.items():
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    out = {"phase_s": time.perf_counter() - t_phase, "launches": totals,
           "teacher": teacher_c}
    log(f"phase 17: {out['phase_s']:.1f} s ({', '.join(parts)} s) [{card}]")
    log(json.dumps({"phase17": out}))
    return out


# -- phase 18: the serving surfaces ------------------------------------------------

SERVE_ROUNDS = 2              # rounds of N_SLIDES concurrent POST /register requests
SERVED = ("gather_patches", "fused_hex_corrector_labels", "fused_generalized_linear_attention")


def http_json(url, body=None):
    """(status, JSON body) of a GET (``body`` None) or a POST of ``body``."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def counted(torch, port, tally=None):
    """The counts of the gather, the labels corrector and FAVOR set to 0
    just before the block and read just after, into the dict yielded (and
    added to ``tally``)."""
    from gridnext_tpu_torch.ops import favor_cuda

    gather, corr = port[7], port[8]
    torch.cuda.synchronize()
    gather.launches = favor_cuda.launches = 0
    for k in corr.launches:
        corr.launches[k] = 0
    got = {}
    yield got
    torch.cuda.synchronize()
    got.update(zip(SERVED, (gather.launches, corr.launches["fused_hex_corrector_labels"],
                            favor_cuda.launches)))
    if tally is not None:
        for k, v in got.items():
            tally[k] = tally.get(k, 0) + v


def turns_ms(torch, calls: dict, rounds: int = 2) -> dict:
    """Host ms of each of ``calls`` (synchronised), run in turns a b b a
    ``rounds`` times after one warm call each: the median per name."""
    times = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    order = list(calls) + list(calls)[::-1]
    for _ in range(rounds):
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def phase_serve(torch, slides, port, card, tmp, dirs_masks, image, batch4, launches) -> float:
    """Phase 18 (a)-(b) in phase 10's directory: phase 4's model directory
    served over HTTP, exported and registered through ``serve-artifact``.
    Returns the seconds taken."""
    import threading

    from gridnext_tpu_torch import cli, ingest, server

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    dev = slides.device
    log("== phase 18 (a)-(b): serve, export and serve-artifact at full width (phase 4's "
        "TpuPatchClassifier model directory, the 4 slides as .npy; TF32 off)")
    t_phase = time.perf_counter()
    srds = [d for d, _ in dirs_masks]
    masks = [m for _, m in dirs_masks]
    files, reg = image["files"], image["registrar"]
    positions = [io.read_positions(d) for d in srds]
    logits = [reg.register_logits(slides[i], positions[i])[0] for i in range(N_SLIDES)]
    want = batch4["labels_b"]
    decode = ingest.decode_slide
    ingest.decode_slide = np.load          # the card has no PIL: .npy slides
    try:
        # (a) the resident server: POST /register from N_SLIDES threads at once
        t0 = time.perf_counter()
        service = server.RegistrationService.from_model_dir(image["model_dir"], device=dev)
        t_load = time.perf_counter() - t0
        httpd = server.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        responses, latencies, walls = {}, [], []
        try:
            t0 = time.perf_counter()
            service.register(srds[0], image=files[0])      # serve --warmup
            t_warm = time.perf_counter() - t0
            service.reset_metrics()

            def post(r, i):
                t = time.perf_counter()
                responses[r, i] = http_json(base + "/register", {
                    "image": files[i], "spaceranger": srds[i], "loupe": True})
                latencies.append(time.perf_counter() - t)

            with counted(torch, port, launches["serve"]) as n_serve:
                for r in range(SERVE_ROUNDS):
                    threads = [threading.Thread(target=post, args=(r, i))
                               for i in range(N_SLIDES)]
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    walls.append(time.perf_counter() - t0)
            code_m, metrics = http_json(base + "/metrics")
            code_bad, bad = http_json(base + "/register", {"image": files[0]})
        finally:
            httpd.shutdown()
            httpd.server_close()
        failed = {k: v for k, v in responses.items() if v[0] != 200}
        if failed or len(responses) != SERVE_ROUNDS * N_SLIDES:
            raise AssertionError(f"serve: {len(responses)} responses, failed {failed}")
        if code_m != 200 or metrics["requests"] != SERVE_ROUNDS * N_SLIDES:
            raise AssertionError(f"serve: GET /metrics {code_m} {metrics}")
        if metrics["batched_slides"] < 2:
            raise AssertionError(f"serve: the micro-batcher grouped no requests: {metrics}")
        if code_bad != 400 or "spaceranger" not in bad.get("error", ""):
            raise AssertionError(f"serve: a request without 'spaceranger' gave {code_bad} {bad}")
        if not (n_serve["gather_patches"] == n_serve["fused_hex_corrector_labels"]
                == metrics["dispatches"] > 0):
            raise AssertionError(f"serve: launches {n_serve}, {metrics['dispatches']} "
                                 "dispatches (one gather and one corrector a dispatch)")
        flips = same_csv = 0
        for (r, i), (_, resp) in sorted(responses.items()):
            got = np.asarray(resp["labels"])
            flips += serving.label_parity_report(want[i], got, logits[i])
            if resp["n_foreground"] != int(masks[i].sum()):
                raise AssertionError(f"serve: slide {i} has {resp['n_foreground']} "
                                     f"foreground spots, the mask {masks[i].sum()}")
            with open(os.path.join(image["csv_dir"], f"slide{i}_loupe.csv")) as fh:
                same_csv += resp["loupe_csv"] == fh.read()
        lat = np.asarray(latencies) * 1e3
        n_req = SERVE_ROUNDS * N_SLIDES
        log(f"(a) serve: model directory loaded in {t_load:.2f} s, warm-up request "
            f"{t_warm:.2f} s; {n_req} requests in {SERVE_ROUNDS} rounds of {N_SLIDES} "
            f"concurrent: {metrics['dispatches']} dispatches, {metrics['batched_slides']} "
            f"slides batched; warm ms per request p50 {np.median(lat):.1f}, max "
            f"{lat.max():.1f}; {n_req / sum(walls):.2f} requests/s (rounds "
            f"{[round(w, 3) for w in walls]} s); stage s "
            f"{json.dumps({k: round(v, 3) for k, v in metrics['stage_seconds'].items()})}; "
            f"labels phase 4's up to {flips} near-tie flips, {same_csv}/{n_req} Loupe texts "
            f"equal to the register command's CSVs; launches {json.dumps(n_serve)}; "
            f"GET /metrics 200, a bad request 400 [{card}]")

        # (b) export: the artifact in-process, then serve-artifact
        art = os.path.join(tmp, "reg.pt2")
        h, w = slides.shape[1:3]
        t0 = time.perf_counter()
        cli.main(["export", "--model", image["model_dir"], "--out", art, "--wsi-shape",
                  str(h), str(w), "--device", str(dev)])
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn, side = server.load_artifact(art, dev)
        t_art = time.perf_counter() - t0
        ins = [serving.artifact_spot_inputs(tuple(slides.shape[1:]), positions[i],
                                            side["n_spots"], window_size=side["window_px"],
                                            h_st=side["h_st"], w_st=side["w_st"])
               for i in range(N_SLIDES)]
        with counted(torch, port, launches["artifact"]) as n_art:
            art_labels = [server.run_artifact(fn, slides[i], ins[i], dev)
                          for i in range(N_SLIDES)]
        with counted(torch, port) as n_one:
            server.run_artifact(fn, slides[0], ins[0], dev)
        one = {"gather_patches": 1, "fused_hex_corrector_labels": 1,
               "fused_generalized_linear_attention": 0}
        if n_one != one or n_art != {k: v * N_SLIDES for k, v in one.items()}:
            raise AssertionError(f"artifact launches: one call {n_one}, {N_SLIDES} calls "
                                 f"{n_art} (want {one} a call)")
        art_flips = sum(serving.label_parity_report(want[i], art_labels[i], logits[i])
                        for i in range(N_SLIDES))
        ms = turns_ms(torch, {"artifact": lambda: server.run_artifact(fn, slides[0], ins[0], dev),
                              "live": lambda: reg(slides[0], positions[0])})
        out = os.path.join(tmp, "served")
        with counted(torch, port, launches["artifact"]) as n_cli:
            t0 = time.perf_counter()
            cli.main(["serve-artifact", "--artifact", art, "--spaceranger", *srds[:2],
                      "--images", *files[:2], "--out", out, "--device", str(dev)])
            t_cli = time.perf_counter() - t0
        if n_cli["gather_patches"] != 2 or n_cli["fused_hex_corrector_labels"] != 2:
            raise AssertionError(f"serve-artifact over 2 slides: launches {n_cli}")
        cli_flips = same = 0
        for i in range(2):
            name = f"slide{i}_loupe.csv"
            grid, n_rows = loupe_grid(os.path.join(out, name), masks[i].shape,
                                      image["classes"])
            if n_rows != int(masks[i].sum()):
                raise AssertionError(f"serve-artifact CSV of slide {i}: {n_rows} rows")
            reg_grid, _ = loupe_grid(os.path.join(image["csv_dir"], name), masks[i].shape,
                                     image["classes"])
            cli_flips += serving.label_parity_report(reg_grid, grid, logits[i])
            with open(os.path.join(out, name)) as a, \
                    open(os.path.join(image["csv_dir"], name)) as b:
                same += a.read() == b.read()
        log(f"(b) export: {t_export:.2f} s (the command, model load included; "
            f"{os.path.getsize(art) / 1e6:.1f} MB, n_spots {side['n_spots']}), load "
            f"{t_art:.2f} s; the artifact's labels phase 4's up to {art_flips} near-tie flips "
            f"over {N_SLIDES} slides; one call launches {json.dumps(n_one)}; ms/slide "
            f"artifact {ms['artifact']:.2f} against the live registrar's {ms['live']:.2f} "
            f"(slide 0, median of 4 in turns); serve-artifact over 2 slides {t_cli:.2f} s, "
            f"its CSVs the register command's up to {cli_flips} near-tie flips ({same}/2 "
            f"byte-equal) [{card}]")
    finally:
        ingest.decode_slide = decode
    return time.perf_counter() - t_phase


def phase_export_dense(torch, port, card, tmp, hd, launches) -> float:
    """Phase 18 (c) in phase 12's directory: ``export --dense`` of slide E's
    exact-pitch lattice, the artifact against ``register_dense``."""
    from gridnext_tpu_torch import cli, server

    serving = port[6]
    dev = hd["wsi"].device
    t_phase = time.perf_counter()
    art = os.path.join(tmp, "hd.pt2")
    h, w = hd["wsi"].shape[:2]
    t0 = time.perf_counter()
    cli.main(["export", "--model", hd["model_dir"], "--dense", "--spaceranger", hd["srd"],
              "--wsi-shape", str(h), str(w), "--out", art, "--device", str(dev)])
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, side = server.load_artifact(art, dev)
    t_art = time.perf_counter() - t0
    _, oy0, ox0, fg, ey, ex = hd["plan"]
    if side["kind"] != "dense" or side["extent"] != [ey, ex]:
        raise AssertionError(f"export --dense wrote {side}")
    with counted(torch, port, launches["artifact"]) as n_art:
        labels = server.run_artifact(fn, hd["wsi"], (oy0, ox0, fg), dev)
    if n_art["gather_patches"] != 1:
        raise AssertionError(f"the dense artifact's launches {n_art} (one gather a call)")
    flips = serving.label_parity_report(hd["labels"], labels, hd["logits"])
    reg = hd["registrar"]
    ms = turns_ms(torch, {
        "artifact": lambda: server.run_artifact(fn, hd["wsi"], (oy0, ox0, fg), dev),
        "register_dense": lambda: reg.register_dense(hd["wsi"], hd["positions"],
                                                     plan=hd["plan"])})
    log(f"(c) export --dense of slide E ({ey} x {ex} bins): {t_export:.2f} s, load "
        f"{t_art:.2f} s; labels register_dense's up to {flips} near-tie flips; launches "
        f"{json.dumps(n_art)}; ms/slide artifact {ms['artifact']:.2f} against "
        f"register_dense's {ms['register_dense']:.2f} (median of 4 in turns) [{card}]")
    return time.perf_counter() - t_phase


def phase_export_mm(torch, slides, port, card, tmp, kinds, mm, launches) -> float:
    """Phase 18 (d) in phase 13's directory: ``export`` of (a)'s scBERT +
    DenseNet-121 directory (depth ``MM_STEP_DEPTH``), its artifact over slide
    0 with the tissue mask as an input, against (a)'s labels."""
    from gridnext_tpu_torch import cli, geometry, modeldir
    from gridnext_tpu_torch.serving import label_parity_report, load_exported_registration

    dev = slides.device
    t_phase = time.perf_counter()
    art = os.path.join(tmp, "mm.pt2")
    t0 = time.perf_counter()
    cli.main(["export", "--model", kinds["model_dir"], "--out", art, "--device", str(dev)])
    t_export = time.perf_counter() - t0
    with open(art + ".json") as fh:
        side = json.load(fh)
    t0 = time.perf_counter()
    with open(art, "rb") as fh:
        fn = load_exported_registration(fh.read())
    t_art = time.perf_counter() - t0
    if not side["explicit_fg"] or side["grid_shapes"][1][-1] != MM_VOCAB:
        raise AssertionError(f"export of the scBERT directory wrote {side}")
    xi = slide_grid(torch, slides[0], kinds["positions"], port)[None]
    xc = torch.as_tensor(modeldir.scbert_transform(kinds["symbols"], MM_VOCAB)(mm["raw"]),
                         device=dev)[None]
    fg = torch.as_tensor((mm["raw"].sum(-1) > 0).astype(np.int32), device=dev)[None]
    with counted(torch, port, launches["artifact"]) as n_art:
        t0 = time.perf_counter()
        labels = fn(xi, xc, fg)[0].cpu().numpy()
        t_run = time.perf_counter() - t0
    want = -(-geometry.VISIUM_H_ST * geometry.VISIUM_W_ST // COUNT_CHUNK) * MM_STEP_DEPTH
    if n_art["fused_generalized_linear_attention"] != want or n_art["gather_patches"]:
        raise AssertionError(f"the scBERT artifact's launches {n_art} (want {want} FAVOR "
                             "calls: a layer each count chunk)")
    flips = label_parity_report(kinds["labels"], labels, kinds["logits"])
    log(f"(d) export of (a)'s scBERT (depth {MM_STEP_DEPTH}) + DenseNet-121 directory: "
        f"{t_export:.2f} s, {os.path.getsize(art) / 1e6:.1f} MB, load {t_art:.2f} s; slide 0 "
        f"through the artifact {t_run:.2f} s, its labels phase 13 (a)'s up to {flips} "
        f"near-tie flips; launches {json.dumps(n_art)} [{card}]")
    del xi, xc
    return time.perf_counter() - t_phase


def phase_serve_count(torch, port, card, tier, dev) -> float:
    """Phase 18 (a), a count request in phase 15's directory: the trained
    train-count directory served, array 0 registered through it."""
    from gridnext_tpu_torch import server

    serving = port[6]
    t_phase = time.perf_counter()
    service = server.RegistrationService.from_model_dir(tier["model"], device=dev)
    body = {"spaceranger": tier["dirs"][0], "loupe": True}
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        resp = service.handle_register(body)
        times.append(time.perf_counter() - t0)
    ref = tier["ref0"]
    flips = serving.label_parity_report(ref["labels"], np.asarray(resp["labels"]),
                                        ref["logits"])
    with open(ref["csv"]) as fh:
        same = resp["loupe_csv"] == fh.read()
    log(f"(a) serve of the train-count directory, array 0 ({TIER_GENES} genes): "
        f"{times[0]:.2f} s the first request, {times[1]:.2f} s warm (the cache read "
        f"included); labels the directory's forward up to {flips} near-tie flips, Loupe "
        f"text {'equal to' if same else 'other than'} the register command's [{card}]")
    return time.perf_counter() - t_phase


# -- phase 19: the parallel tier and the cohort workflows ----------------------------

MESH_STEPS = 8                # (b)'s spotwise steps of batch TRAIN_BATCH
MESH_LR = 1e-3                # (b)'s learning rate (train-image's --f-lr)
MESH_GRID = 32                # (b)'s grid step: 2 windows of 32 x 32 cells, one a rank
MESH_MLM_DEPTH = 2            # (b)'s PerformerLM layers at scBERT's widths (cut from 6)
MESH_MLM_STEPS = 2            # (b)'s MLM steps of PRETRAIN_BATCH rows, a redraw after each
MESH_WEIGHTS_OUT = 3e-3       # (b): share of weights beyond 1e-4 abs + 1e-3 rel of the
#                               32-row run (read 9.80e-4 and 9.86e-4 in PR 15's runs)
HVG_GENES = 2000              # (d)'s highly variable genes
PCA_VARIANCE = 0.5            # (d)'s variance target for n_pcs


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_spot_worker(argv) -> int:
    """Phase 19 (b)'s process: ``coordinator world rank out_dir srd npy
    csv``. ``world`` 2: one of two gloo ranks; 0: the single-process
    reference; -1: the witness, one process that does the ranks' arithmetic
    without collectives (:func:`witness_spot_steps`).

    Trains a TpuPatchClassifier spotwise over slide 0's first
    ``TRAIN_BATCH`` spots for ``MESH_STEPS`` steps (one an epoch: the epoch
    losses are the step losses) with its checkpoint in ``out_dir/<tag>``;
    then, except in the witness, one GridNetHex grid step
    (:func:`mesh_grid_step`) and ``MESH_MLM_STEPS`` MLM steps through FAVOR
    (:func:`mesh_mlm_steps`). Saves the losses, the kernels' launches, the
    first step's summed gradients and the final variables in
    ``out_dir/result_<tag>.npz`` (tag ``r<rank>``, ``ref`` or ``wit``).
    Exit 3: gloo refused a CUDA collective (printed), which fails the
    phase."""
    import torch
    import torch.distributed as dist

    from gridnext_tpu_torch import ingest, models
    from gridnext_tpu_torch.data import Subset, create_visium_dataset
    from gridnext_tpu_torch.ops import patch_gather_cuda as gather
    from gridnext_tpu_torch.parallel import initialize_multihost
    from gridnext_tpu_torch.train import loops as tl

    coord, world, rank, out_dir, srd, npy, csv_file = argv
    world, rank = int(world), int(rank)
    tag = {0: "ref", -1: "wit"}.get(world, f"r{rank}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # one algorithm a shape, run to run: the witness holds the ranks to
    # the same arithmetic, not to the rounding of another algorithm
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    if world > 0:
        initialize_multihost(coord, world, rank, backend="gloo", device=dev, timeout=300)
        for name, probe in (("all_reduce SUM", lambda t: dist.all_reduce(t)),
                            ("all_reduce MAX", lambda t: dist.all_reduce(
                                t, op=dist.ReduceOp.MAX)),
                            ("broadcast", lambda t: dist.broadcast(t, 0))):
            try:
                probe(torch.ones(4, device=dev))
            except RuntimeError as e:
                print(f"gloo refused {name} on a CUDA tensor: {e}", flush=True)
                return 3
    ingest.decode_slide = np.load
    spots = create_visium_dataset([srd], spatial=False, use_count=False, annot_files=[csv_file],
                                  fullres_image_files=[npy], patch_size_px=PATCH, device=dev)
    f = models.TpuPatchClassifier(n_classes=N_CLASSES)
    out = os.path.join(out_dir, tag)
    os.makedirs(out, exist_ok=True)
    state = tl.create_train_state(f, tl.make_adam(MESH_LR),
                                  generator=torch.Generator().manual_seed(SEED), device=dev)
    grads0 = {}
    apply = state.optimizer.step

    def step():                      # the first step's (summed) gradients
        if not grads0:
            grads0.update({f"grad0/{n}": p.grad.detach().cpu().numpy()
                           for n, p in f.named_parameters() if p.grad is not None})
        apply()

    state.optimizer.step = step
    gather.launches = 0
    if world >= 0:
        state, _, losses = tl.train_spotwise(
            f, {"train": Subset(spots, np.arange(TRAIN_BATCH))}, state=state,
            num_epochs=MESH_STEPS, batch_size=TRAIN_BATCH,
            outfile=os.path.join(out, "f.msgpack"), verbose=False, device=dev,
            mesh_shape={"data": world} if world else None)
    else:
        losses = witness_spot_steps(torch, tl, state, spots, dev)
    torch.cuda.synchronize()
    flat = {"/".join(k): v for k, v in tree_leaves(state.variables())}
    result = {"losses": np.asarray(losses), "gather_launches": gather.launches,
              **flat, **grads0}
    del state, f, spots
    if world >= 0:
        result.update(mesh_grid_step(torch, tl, models, dev, world))
        result.update(mesh_mlm_steps(torch, tl, models, dev, world))
    else:
        result.update(witness_mlm_steps(torch, tl, models, dev))
    np.savez(os.path.join(out_dir, f"result_{tag}.npz"), **result)
    if world > 0:
        dist.destroy_process_group()
    return 0


def witness_spot_steps(torch, tl, state, spots, dev) -> list:
    """The two ranks' spot stage in one process, without collectives: each
    step's shuffled batch (``train_spotwise``'s shuffle) in its two halves,
    each forward and backward apart as on its rank (its loss over the
    global count, its rows of the step's random draws), the halves'
    gradients summed in float32 (what gloo's SUM of two gives), one Adam
    step. Returns the step losses, each the halves' sum."""
    from gridnext_tpu_torch.models.layers import set_dropout_generator
    from gridnext_tpu_torch.parallel import collectives

    model, params = state.model, state.optimizer.trainable
    rng = np.random.default_rng(0)            # train_spotwise's shuffle_seed
    half = TRAIN_BATCH // 2
    losses = []
    for _ in range(MESH_STEPS):
        order = rng.permutation(TRAIN_BATCH)
        model.train()
        total, summed = None, None
        for r in range(2):
            x, y = spots.batch(order[r * half:(r + 1) * half])
            set_dropout_generator(model, tl._step_generator(tl._DROPOUT_SEED, state.step, dev))
            with collectives.sharded(rows=collectives.RowShard(r * half, (r + 1) * half,
                                                               TRAIN_BATCH)):
                loss, _, _ = tl._spot_loss(model(x), torch.as_tensor(y, device=dev),
                                           lambda n: torch.full_like(n, TRAIN_BATCH))
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                params, torch.autograd.grad(loss, params, allow_unused=True))]
            summed = grads if summed is None else [a + b for a, b in zip(summed, grads)]
            total = loss.detach().double() if total is None else total + loss.detach().double()
        for p, g in zip(params, summed):
            p.grad = g
        state.optimizer.step()
        state.step += 1
        losses.append(float(total.float()))
    return losses


def _mesh_rows(torch, tl, kind: str, batch: int, world: int):
    """(this process's rows of a global batch, its mesh step or None)."""
    if not world:
        return slice(None), None
    mesh = tl._resolve_mesh(None, {"data": world})
    rows = tl._mesh_placement(mesh, kind, batch)(np.arange(batch))
    return slice(int(rows[0]), int(rows[-1]) + 1), tl._MeshStep(rows, batch)


def mesh_grid_step(torch, tl, models, dev, world) -> dict:
    """One GridNetHex grid step (TpuPatchClassifier f frozen, g with its
    BatchNorm layers in train mode) over two ``MESH_GRID`` x ``MESH_GRID``
    windows of random 128-px patches and labels from a seed: on 2 ranks one
    window each, g's BatchNorm over the global batch through gloo's
    all-reduce of CUDA tensors. Returns the loss, g's gradients and its
    updated BatchNorm statistics."""
    from gridnext_tpu_torch.compat.from_jax import model_entries

    g = models.GridNetHex(models.TpuPatchClassifier(n_classes=N_CLASSES), N_CLASSES,
                          N_CLASSES)
    state = tl.create_train_state(g, tl.make_gridwise_optimizer(MESH_LR),
                                  generator=torch.Generator().manual_seed(SEED + 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.rand((2, MESH_GRID, MESH_GRID, PATCH, PATCH, 3), generator=gen, device=dev)
    y = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, N_CLASSES + 1, (2, MESH_GRID, MESH_GRID)), device=dev)
    rows, ms = _mesh_rows(torch, tl, "grid", 2, world)
    grads = {}
    apply = state.optimizer.step

    def capture():
        grads.update({f"grid_grad/{n}": p.grad.detach().cpu().numpy()
                      for n, p in g.named_parameters() if p.grad is not None})
        apply()

    state.optimizer.step = capture
    step, _ = tl.make_steps(state, "grid", mesh_step=ms)
    m = step(x[rows], y[rows])
    torch.cuda.synchronize()
    stats = {"grid_stats/" + "/".join(path): t.detach().cpu().numpy()
             for path, t, _ in model_entries(g) if path[0] == "batch_stats"}
    return {"grid_loss": float(m["loss"]), **grads, **stats}


def _mesh_lm(torch, tl, models, dev):
    """(a PerformerLM at scBERT's widths (16,907 tokens, dim 200, 10 heads,
    dim_head 64, m 266; depth cut to ``MESH_MLM_DEPTH``) with its state
    from a seed, ``PRETRAIN_BATCH`` rows of random bins, the dict its
    optimizer's first step fills with the gradients)."""
    lm = models.PerformerLM(num_tokens=7, max_seq_len=MM_VOCAB + 1, dim=MM_DIM,
                            depth=MESH_MLM_DEPTH, heads=MM_HEADS, dim_head=MM_DIM_HEAD,
                            nb_features=266, generalized_attention=True)
    state = tl.create_train_state(lm, tl.make_adam(1e-4),
                                  generator=torch.Generator().manual_seed(SEED + 2), device=dev)
    tokens = np.random.default_rng(SEED + 2).integers(0, 6, (PRETRAIN_BATCH, MM_VOCAB + 1))
    grads = {}
    apply = state.optimizer.step

    def capture():
        if not grads:
            grads.update({f"mlm_grad0/{n}": p.grad.detach().cpu().numpy()
                          for n, p in lm.named_parameters() if p.grad is not None})
        apply()

    state.optimizer.step = capture
    return lm, state, tokens, grads


def _mlm_result(lm, losses, grads, launches) -> dict:
    proj = {f"mlm_proj/{k}": v.cpu().numpy() for k, v in lm.state_dict().items()
            if k.endswith("fast_attention.projection")}
    return {"mlm_losses": np.asarray(losses), "favor_launches": launches, **grads, **proj}


def mesh_mlm_steps(torch, tl, models, dev, world) -> dict:
    """``train_mlm`` of :func:`_mesh_lm`'s model over its rows,
    ``MESH_MLM_STEPS`` epochs of one step, the FAVOR projections redrawn
    after every step: on 2 ranks 2 rows each, the MLM mask drawn for the
    global batch. Returns the step losses, the first step's gradients, the
    final projections and FAVOR's launches."""
    from gridnext_tpu_torch.ops import favor_cuda

    lm, state, tokens, grads = _mesh_lm(torch, tl, models, dev)
    favor_cuda.launches = 0
    _, _, losses = tl.train_mlm(lm, {"train": tokens}, mask_id=6, num_epochs=MESH_MLM_STEPS,
                                batch_size=PRETRAIN_BATCH, state=state, redraw_every=1,
                                verbose=False, device=dev,
                                mesh_shape={"data": world} if world else None)
    torch.cuda.synchronize()
    return _mlm_result(lm, losses, grads, favor_cuda.launches)


def witness_mlm_steps(torch, tl, models, dev) -> dict:
    """:func:`mesh_mlm_steps` on 2 ranks, in one process without
    collectives: each step's shuffled rows in two halves, each half's MLM
    mask its rows of the global batch's draw and its loss over the global
    count, forward and backward apart (FAVOR on 2 rows, as on a rank), the
    gradients summed, one Adam step, then the redraw."""
    from gridnext_tpu_torch.models.layers import set_dropout_generator
    from gridnext_tpu_torch.models.performer import redraw_projections
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.parallel import collectives

    lm, state, tokens, grads = _mesh_lm(torch, tl, models, dev)
    params = state.optimizer.trainable
    rng = np.random.default_rng(0)            # train_mlm's shuffle_seed
    half = PRETRAIN_BATCH // 2
    losses = []
    favor_cuda.launches = 0
    for redraw in range(MESH_MLM_STEPS):
        y = torch.as_tensor(tokens[rng.permutation(PRETRAIN_BATCH)], device=dev)
        mask = tl._mlm_mask(tl._step_generator(tl._MLM_SEED, state.step, dev), y.shape, 0.15,
                            dev)
        count = int((mask & (y >= 0)).sum())
        lm.train()
        total, summed = None, None
        for r in range(2):
            rows = slice(r * half, (r + 1) * half)
            set_dropout_generator(lm, tl._step_generator(tl._DROPOUT_SEED, state.step, dev))
            with collectives.sharded(rows=collectives.RowShard(rows.start, rows.stop,
                                                               PRETRAIN_BATCH)):
                x = torch.where(mask[rows], torch.full_like(y[rows], 6), y[rows].clamp_min(0))
                loss, _, _ = tl.mlm_loss(lm(x.long()), y[rows], mask[rows],
                                         lambda n: torch.full_like(n, count))
            g = [torch.zeros_like(p) if t is None else t for p, t in zip(
                params, torch.autograd.grad(loss, params, allow_unused=True))]
            summed = g if summed is None else [a + b for a, b in zip(summed, g)]
            total = loss.detach().double() if total is None else total + loss.detach().double()
        for p, t in zip(params, summed):
            p.grad = t
        state.optimizer.step()
        state.step += 1
        redraw_projections(lm, tl._step_generator(tl._REDRAW_SEED, redraw, "cpu"))
        losses.append(float(total.float()))
    torch.cuda.synchronize()
    return _mlm_result(lm, losses, grads, favor_cuda.launches)


def _rel_to_largest(got: dict, want: dict, keys) -> float:
    """The worst ``max |got - want|`` over a tensor's largest ``|want|``."""
    return max((float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                for k in keys), default=0.0)


def phase_mesh_ranks(torch, card, tmp, cohort) -> dict:
    """Phase 19 (b): two gloo ranks on the one card against the witness and
    the single-process reference, four processes at once."""
    log("== phase 19 (b): a TpuPatchClassifier spot stage on 2 gloo ranks sharing the card "
        f"(batch {TRAIN_BATCH}, {MESH_STEPS} steps) against the witness (one process, the "
        "halves summed) and one process; a GridNetHex grid step and "
        f"{MESH_MLM_STEPS} MLM steps through FAVOR on the same ranks")
    t0 = time.perf_counter()
    # the workers share the card: hand back this process's cached blocks
    # (phase 17 (c) peaks at 66 GiB)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "mesh_b")
    os.makedirs(out_dir)
    coord = f"127.0.0.1:{free_port()}"
    args = [out_dir, cohort["dirs"][0], cohort["npys"][0], cohort["csvs"][0]]
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.mesh_spot_worker(sys.argv[1:]))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(world), str(rank), *args],
                              cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for world, rank in ((0, 0), (-1, 0), (2, 0), (2, 1))]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    if codes != [0, 0, 0, 0]:
        raise AssertionError(f"(b) workers exited {codes}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    ref, wit, r0, r1 = (dict(np.load(os.path.join(out_dir, f"result_{t}.npz")))
                        for t in ("ref", "wit", "r0", "r1"))
    written = {t: sorted(os.listdir(os.path.join(out_dir, t))) for t in ("r0", "r1")}
    if written["r1"] or "f.msgpack" not in written["r0"]:
        raise AssertionError(f"(b) files written by rank: {written}")
    launches = [int(r["gather_launches"]) for r in (ref, r0, r1)]
    if launches != [MESH_STEPS] * 3:
        raise AssertionError(f"(b) gather launches (reference, rank 0, rank 1) {launches}, "
                             f"want one a batch ({MESH_STEPS})")
    favor = [int(r["favor_launches"]) for r in (ref, r0, r1)]
    if favor != [MESH_MLM_DEPTH * MESH_MLM_STEPS] * 3:
        raise AssertionError(f"(b) FAVOR launches (reference, rank 0, rank 1) {favor}, want "
                             f"one a layer a step ({MESH_MLM_DEPTH * MESH_MLM_STEPS})")
    if sorted(r0) != sorted(r1) or any(not np.array_equal(r0[k], r1[k]) for k in r0):
        raise AssertionError("(b) the two ranks' weights, gradients, losses or statistics "
                             "differ")
    # the spot stage. Against the witness (the same arithmetic): every loss,
    # gradient and weight within about 1e-6. Against the 32-row process
    # (other rounding: convolutions over 16 rows against 32, which Adam
    # turns into +-lr on elements of near-zero gradient): the first step's
    # loss within 1e-6 and gradients within 1e-4 of each tensor's largest,
    # the 8 losses within 1e-4, the share of weights off bounded
    keys = [k for k in wit if k not in ("losses", "gather_launches", "favor_launches")
            and not k.startswith("mlm_")]
    weights = [k for k in keys if not k.startswith("grad0/")]
    grads = [k for k in keys if k.startswith("grad0/")]
    wit_loss = float(np.max(np.abs(r0["losses"] / wit["losses"] - 1)))
    wit_worst = max(float((np.abs(r0[k].astype(np.float64) - wit[k])
                           / (1e-6 + 1e-5 * np.abs(wit[k].astype(np.float64)))).max())
                    for k in keys)
    grad_rel = _rel_to_largest(r0, ref, grads)
    loss0_rel = float(abs(r0["losses"][0] / ref["losses"][0] - 1))
    loss_rel = float(np.max(np.abs(r0["losses"] / ref["losses"] - 1)))
    n_total = n_out = 0
    for k in weights:
        d = np.abs(r0[k].astype(np.float64) - ref[k])
        n_total += d.size
        n_out += int((d > 1e-4 + 1e-3 * np.abs(ref[k])).sum())
    share = n_out / max(n_total, 1)
    log(f"(b) spot stage: losses {np.round(ref['losses'], 5).tolist()} (one process); 2 ranks "
        f"against the witness: losses within {wit_loss:.2e} relative, every weight and "
        f"first-step gradient within {wit_worst:.3g} x (1e-6 abs + 1e-5 rel); against one "
        f"process: the first step's loss within {loss0_rel:.2e} and its gradients within "
        f"{grad_rel:.2e} of each tensor's largest, the {MESH_STEPS} losses within {loss_rel:.2e} "
        f"relative, {n_out} of {n_total} weights ({share:.2e}) beyond 1e-4 abs + 1e-3 rel "
        f"(limit {MESH_WEIGHTS_OUT:.0e}); the ranks bit-equal; {MESH_STEPS} gather launches a "
        f"rank; only rank 0 wrote {written['r0']} [{card}]")
    if wit_loss > 1e-6 or wit_worst > 1:
        raise AssertionError("(b) the 2 ranks left the witness's arithmetic")
    if loss0_rel > 1e-6 or grad_rel > 1e-4 or loss_rel > 1e-4 or share > MESH_WEIGHTS_OUT:
        raise AssertionError("(b) the 2-rank trajectory left the single-process one")
    # the grid step: g's BatchNorm over the global batch of 2 windows
    g_loss = float(abs(r0["grid_loss"] / ref["grid_loss"] - 1))
    g_keys = [k for k in ref if k.startswith("grid_grad/")]
    top = max(float(np.linalg.norm(ref[k])) for k in g_keys)
    live = [k for k in g_keys if np.linalg.norm(ref[k]) > 1e-6 * top]
    g_grad = max(float(np.linalg.norm(r0[k] - ref[k]) / np.linalg.norm(ref[k])) for k in live)
    g_stats = max(float(np.abs(r0[k] - ref[k]).max()) for k in ref if k.startswith("grid_stats/"))
    log(f"(b) GridNetHex grid step over 2 windows of {MESH_GRID} x {MESH_GRID} cells (one a "
        f"rank): loss {float(ref['grid_loss']):.5f}, 2 ranks within {g_loss:.2e} relative; g's "
        f"gradients within {g_grad:.2e} of each tensor's norm ({len(g_keys) - len(live)} "
        f"tensors of zero true gradient left out); updated BatchNorm statistics within "
        f"{g_stats:.2e} [{card}]")
    if g_loss > 1e-5 or g_grad > 1e-4 or g_stats > 1e-5:
        raise AssertionError("(b) the 2-rank grid step left the single-process one")
    # the MLM steps: FAVOR on each rank's rows, the redraws alike. The
    # witness runs FAVOR on 2 rows as the ranks do; the 4-row process takes
    # another split plan (FAVOR splits its sums by the batch x heads), so
    # it is held to FAVOR's forward tolerance (2e-4 relative): the loss
    # within 1e-5, the step-1 gradients within 1e-3 of each tensor's
    # largest
    m_keys = [k for k in wit if k.startswith(("mlm_grad0/", "mlm_proj/"))]
    m_wit_loss = float(np.max(np.abs(r0["mlm_losses"] / wit["mlm_losses"] - 1)))
    m_wit = max(float((np.abs(r0[k].astype(np.float64) - wit[k])
                       / (1e-6 + 1e-5 * np.abs(wit[k].astype(np.float64)))).max())
                for k in m_keys)
    m_loss0 = float(abs(r0["mlm_losses"][0] / ref["mlm_losses"][0] - 1))
    m_loss = float(np.max(np.abs(r0["mlm_losses"] / ref["mlm_losses"] - 1)))
    m_grad = _rel_to_largest(r0, ref, [k for k in ref if k.startswith("mlm_grad0/")])
    projs = [k for k in ref if k.startswith("mlm_proj/")]
    same_proj = len(projs) == MESH_MLM_DEPTH and all(np.array_equal(r0[k], ref[k])
                                                     for k in projs)
    log(f"(b) {MESH_MLM_STEPS} MLM steps (PerformerLM at scBERT's widths, depth "
        f"{MESH_MLM_DEPTH}, {PRETRAIN_BATCH} rows, a redraw after each step): losses "
        f"{np.round(ref['mlm_losses'], 5).tolist()} (one process); 2 ranks against the "
        f"witness: losses within {m_wit_loss:.2e}, step-1 gradients and projections within "
        f"{m_wit:.3g} x (1e-6 abs + 1e-5 rel); against one process: the first loss within "
        f"{m_loss0:.2e} and its gradients within {m_grad:.2e} of each tensor's largest, both "
        f"losses within {m_loss:.2e}, projections after the redraws equal: {same_proj}; FAVOR "
        f"launches {favor[1]} a rank; phase 19 (b) {time.perf_counter() - t0:.1f} s [{card}]")
    if m_wit_loss > 1e-6 or m_wit > 1:
        raise AssertionError("(b) the 2 ranks' MLM steps left the witness's arithmetic")
    if m_loss > 1e-5 or m_grad > 1e-3 or not same_proj:
        raise AssertionError("(b) the 2-rank MLM steps left the single-process ones")
    return {"witness_loss_rel": wit_loss, "witness_worst": wit_worst, "loss0_rel": loss0_rel,
            "grad_rel": grad_rel, "loss_rel": loss_rel, "weights_out": n_out,
            "weights": n_total, "grid_loss_rel": g_loss, "grid_grad_rel": g_grad,
            "grid_stats": g_stats, "mlm_witness_loss_rel": m_wit_loss,
            "mlm_witness_worst": m_wit, "mlm_loss0_rel": m_loss0, "mlm_grad_rel": m_grad,
            "mlm_loss_rel": m_loss, "gather_launches_per_rank": MESH_STEPS,
            "favor_launches_per_rank": favor[1], "s": time.perf_counter() - t0}


def phase_mesh_register(torch, slides, port, card, image, dirs_masks, batch4) -> dict:
    """Phase 19 (c): phase 4's model directory registered with the flat
    spot axis split over 2 shards on the one card, against the unsharded
    registrar."""
    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.parallel import make_mesh

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    dev = slides.device
    log("== phase 19 (c): SlideRegistrar(mesh) with 2 spot shards on the card over the 4 "
        "full-width slides (phase 4's TpuPatchClassifier model directory)")
    meta, classes, variables = load_model_dir(image["model_dir"])
    reg = image["registrar"]
    sharded = modeldir.image_registrar_from_meta(
        meta, classes, variables, device=dev, mesh=make_mesh({"spot": 2}, devices=[dev, dev]))
    positions = [io.read_positions(d) for d, _ in dirs_masks]
    with counted(torch, port) as got:
        labels = sharded.register_batch(slides, positions)
    if got["gather_patches"] != 2 or got["fused_hex_corrector_labels"] != 1:
        raise AssertionError(f"(c) launches {got}: want one gather a shard (2) and one "
                             "labels corrector")
    flips = []
    for i in range(N_SLIDES):
        logits = reg.register_logits(slides[i], positions[i])[0]
        flips.append(serving.label_parity_report(batch4["labels_b"][i], labels[i], logits))
    ms = turns_ms(torch, {"one device": lambda: reg.register_batch(slides, positions),
                          "2 shards": lambda: sharded.register_batch(slides, positions)})
    per = {k: v / N_SLIDES for k, v in ms.items()}
    log(f"(c) labels equal to the unsharded registrar's up to {flips} near-tie flips; "
        f"launches {got}; register_batch {per['one device']:.2f} ms/slide on one device, "
        f"{per['2 shards']:.2f} ms/slide over 2 shards of the card [{card}]")
    return {"flips": flips, "launches": got, "ms_per_slide": per}


def phase_mesh_count_tier(torch, card, tmp, tier, dev) -> dict:
    """Phase 19 (a) and (d) in phase 15's directory: train-count over a
    1-rank NCCL process group against the same command without one, and the
    PCA workflow on the card against a float64 fit on the host."""
    from gridnext_tpu_torch import cli
    from gridnext_tpu_torch.io import unify
    from gridnext_tpu_torch.parallel import collectives
    from gridnext_tpu_torch.workflows import (CountTable, filtered_norm_logcounts, fit_pca,
                                              n_pcs_for_variance, scale_logcounts,
                                              select_hvgs_from_count_files)
    from gridnext_tpu_torch.workflows.pca import _scaler_from_normed

    out = {}
    dirs = tier["dirs"]
    annots = [os.path.join(d, f"a{i}_annotations.csv") for i, d in enumerate(dirs)]
    log(f"== phase 19 (a): train-count --mesh data=1 over a 1-rank NCCL process group, "
        f"1 epoch over phase 15's {len(dirs)} arrays, against the same command without a mesh")
    command = ["train-count", "--spaceranger", *dirs, "--annots", *annots, "--epochs", "1",
               "--device", str(dev)]
    runs = {}
    for name, pre, post in (("plain", [], []),
                            ("mesh", ["--coordinator", f"127.0.0.1:{free_port()},1,0"],
                             ["--mesh", "data=1"])):
        model = os.path.join(tmp, f"mesh_a_{name}")
        collectives.reset_counts()
        t0 = time.perf_counter()
        cli.main(pre + command + ["--out", model] + post)
        torch.cuda.synchronize()
        runs[name] = {"s": time.perf_counter() - t0, "counts": dict(collectives.COUNTS),
                      "dir": model}
    files = sorted(os.listdir(runs["plain"]["dir"]))
    same = {f: open(os.path.join(runs["plain"]["dir"], f), "rb").read()
            == open(os.path.join(runs["mesh"]["dir"], f), "rb").read() for f in files}
    counts = runs["mesh"]["counts"]
    log(f"(a) without a mesh {runs['plain']['s']:.2f} s, --mesh data=1 {runs['mesh']['s']:.2f} "
        f"s; collectives {counts} ('grads' the gradient all-reduces, 'stop_flag' the host "
        f"flags; without a mesh {runs['plain']['counts']}); files "
        f"byte-equal: {same} [{card}]")
    if sorted(os.listdir(runs["mesh"]["dir"])) != files or not all(same.values()):
        raise AssertionError("(a) the 1-rank mesh run's checkpoints differ from the run "
                             "without a mesh")
    if counts["grads"] <= 0 or any(runs["plain"]["counts"].values()):
        raise AssertionError("(a) the mesh run reduced no gradient (or the run without a "
                             "mesh launched a collective)")
    out["a"] = {"plain_s": runs["plain"]["s"], "mesh_s": runs["mesh"]["s"], "counts": counts}

    log(f"== phase 19 (d): the PCA workflow over the {len(dirs)} arrays' caches: "
        f"{HVG_GENES} highly variable genes, the cohort scaler, fit_pca on the card against "
        "a float64 fit on the host")
    caches = [unify.unified_cache_path(d) for d in dirs]
    t0 = time.perf_counter()
    hvgs = select_hvgs_from_count_files(caches, n_top_genes=HVG_GENES)
    t_hvg = time.perf_counter() - t0
    t0 = time.perf_counter()
    normed = [filtered_norm_logcounts(c) for c in caches]
    rows = np.asarray([normed[0].genes.index(g) for g in hvgs])
    normed = [CountTable(t.values[rows], hvgs, t.barcodes) for t in normed]
    mean, std = _scaler_from_normed(normed, caches)
    X = np.vstack([scale_logcounts(t, mean, std).values.T for t in normed])
    t_scale = time.perf_counter() - t0
    x = torch.as_tensor(X.astype(np.float32), device=dev)
    fit_pca(x)                                   # the solver's first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = fit_pca(x)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    xc = X - X.mean(0)
    _, sv, vt = np.linalg.svd(xc, full_matrices=False)
    vt *= np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(1)])[:, None]
    var = sv ** 2 / (len(X) - 1)
    ratio64 = var / var.sum()
    t_host = time.perf_counter() - t0
    n_pcs = n_pcs_for_variance(pca, PCA_VARIANCE)
    n64 = int(np.flatnonzero(np.cumsum(ratio64) > PCA_VARIANCE)[0]) + 1
    comp = pca.components_.double().cpu().numpy()
    cos = np.sum(comp[:n64] * vt[:n64], axis=1)
    ratio_err = float(np.abs(pca.explained_variance_ratio_.double().cpu().numpy()
                             - ratio64).max())
    log(f"(d) {X.shape[0]} spots x {X.shape[1]} HVGs: HVG selection {t_hvg:.2f} s, scaler "
        f"{t_scale:.2f} s on the host; fit_pca on the card {t_card:.3f} s, the float64 fit on "
        f"the host {t_host:.3f} s; n_pcs at {PCA_VARIANCE} variance {n_pcs} (float64 {n64}); "
        f"the leading {n64} components' cosines with float64's in [{cos.min():.8f}, "
        f"{cos.max():.8f}]; "
        f"explained_variance_ratio_ within {ratio_err:.2e} [{card}]")
    if n_pcs != n64 or np.abs(cos - 1).max() > 1e-4 or ratio_err > 1e-5:
        raise AssertionError("(d) the card's PCA left the float64 fit")
    out["d"] = {"spots": int(X.shape[0]), "genes": int(X.shape[1]), "hvg_s": t_hvg,
                "scale_s": t_scale, "fit_card_s": t_card, "fit_host_f64_s": t_host,
                "n_pcs": n_pcs, "min_cos": float(cos.min()), "ratio_err": ratio_err}
    return out


# -- phase 20: sequence parallelism, --profile-dir, a reference checkpoint -----------

SEQ_MLM_DEPTH = 2             # (a)'s PerformerLM layers at scBERT's widths (cut from 6)
SEQ_MLM_STEPS = 2             # (a)'s MLM steps of PRETRAIN_BATCH rows, a redraw after each
SEQ_WORLD = 2                 # (a)'s gloo ranks on the 'seq' axis


def _seq_lm(torch, tl, models, dev):
    """(a PerformerLM at scBERT's widths, depth ``SEQ_MLM_DEPTH``, its
    state from a seed, ``PRETRAIN_BATCH`` rows of random bins over the
    16,907 tokens, the dict its optimizer's first step fills with the
    gradients)."""
    lm = models.PerformerLM(num_tokens=7,
                            max_seq_len=tl.mlm_token_len(MM_VOCAB + 1, {"seq": SEQ_WORLD}),
                            dim=MM_DIM, depth=SEQ_MLM_DEPTH, heads=MM_HEADS,
                            dim_head=MM_DIM_HEAD, nb_features=266, generalized_attention=True)
    state = tl.create_train_state(lm, tl.make_adam(1e-4),
                                  generator=torch.Generator().manual_seed(SEED + 3), device=dev)
    tokens = np.random.default_rng(SEED + 3).integers(0, 6, (PRETRAIN_BATCH, MM_VOCAB + 1))
    grads = {}
    apply = state.optimizer.step

    def capture():
        if not grads:
            grads.update({f"grad0/{n}": p.grad.detach().cpu().numpy()
                          for n, p in lm.named_parameters() if p.grad is not None})
        apply()

    state.optimizer.step = capture
    return lm, state, tokens, grads


def seq_mlm_worker(argv) -> int:
    """Phase 20 (a)'s process: ``coordinator world rank out_dir``. ``world``
    2: one of two gloo ranks on ``{'data': 1, 'seq': 2}`` (``train_mlm``
    pads the 16,907 tokens to 16,908 with a -1 column); 0: the one-process
    reference on the padded corpus. Saves the losses, the first step's
    gradients, the final weights and FAVOR's three counts (set to 0 just
    before ``train_mlm``, read just after) in ``out_dir/result_<tag>.npz``.
    A gloo refusal of a CUDA collective raises, and fails the phase."""
    import torch
    import torch.distributed as dist

    from gridnext_tpu_torch import models
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.parallel import collectives, initialize_multihost
    from gridnext_tpu_torch.train import loops as tl

    coord, world, rank, out_dir = argv
    world, rank = int(world), int(rank)
    tag = "ref" if world == 0 else f"r{rank}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if world:
        initialize_multihost(coord, world, rank, backend="gloo", device=dev, timeout=300)
    lm, state, tokens, grads = _seq_lm(torch, tl, models, dev)
    if not world:
        tokens = np.concatenate([tokens, np.full((len(tokens), 1), -1, tokens.dtype)], axis=1)
    favor_cuda.launches = favor_cuda.accumulate_launches = favor_cuda.apply_launches = 0
    collectives.reset_counts()
    _, _, losses = tl.train_mlm(lm, {"train": tokens}, mask_id=6, num_epochs=SEQ_MLM_STEPS,
                                batch_size=PRETRAIN_BATCH, state=state, redraw_every=1,
                                verbose=False, device=dev,
                                mesh_shape={"data": 1, "seq": world} if world else None)
    torch.cuda.synchronize()
    counts = {"fused": favor_cuda.launches, "accumulate": favor_cuda.accumulate_launches,
              "apply": favor_cuda.apply_launches, "seq_sums": collectives.COUNTS["favor_seq"]}
    weights = {f"w/{k}": v.detach().cpu().numpy() for k, v in lm.state_dict().items()}
    np.savez(os.path.join(out_dir, f"result_{tag}.npz"), losses=np.asarray(losses),
             **{f"count/{k}": v for k, v in counts.items()}, **grads, **weights)
    if world:
        dist.destroy_process_group()
    return 0


def phase_seq_ranks(torch, card, tmp) -> dict:
    """Phase 20 (a): 2 gloo ranks on the 'seq' axis and the one-process
    reference, three processes at once on the card."""
    log(f"== phase 20 (a): train_mlm on {{'data': 1, 'seq': {SEQ_WORLD}}} (2 gloo ranks "
        f"sharing the card) against one process: PerformerLM at scBERT's widths, depth "
        f"{SEQ_MLM_DEPTH}, {PRETRAIN_BATCH} rows x {MM_VOCAB + 1} tokens (padded to "
        f"{MM_VOCAB + 2}), {SEQ_MLM_STEPS} steps")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()           # the workers share the card
    out_dir = os.path.join(tmp, "seq_a")
    os.makedirs(out_dir)
    coord = f"127.0.0.1:{free_port()}"
    code = "import sys, chip_smoke; sys.exit(chip_smoke.seq_mlm_worker(sys.argv[1:]))"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(world), str(rank),
                               out_dir], cwd=os.path.dirname(os.path.abspath(__file__)),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for world, rank in ((0, 0), (SEQ_WORLD, 0), (SEQ_WORLD, 1))]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    if codes != [0, 0, 0]:
        raise AssertionError(f"(a) workers exited {codes}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    ref, r0, r1 = (dict(np.load(os.path.join(out_dir, f"result_{t}.npz")))
                   for t in ("ref", "r0", "r1"))
    if sorted(r0) != sorted(r1) or any(not np.array_equal(r0[k], r1[k]) for k in r0
                                       if k.startswith(("w/", "losses"))):
        raise AssertionError("(a) the two ranks' weights or losses differ")
    per_step = SEQ_MLM_DEPTH * SEQ_MLM_STEPS
    counts = {t: {k.split("/")[1]: int(r[k]) for k in r if k.startswith("count/")}
              for t, r in (("ref", ref), ("r0", r0), ("r1", r1))}
    want = {"ref": {"fused": per_step, "accumulate": 0, "apply": 0, "seq_sums": 0},
            "r0": {"fused": 0, "accumulate": per_step, "apply": per_step,
                   "seq_sums": per_step}}
    want["r1"] = want["r0"]
    if counts != want:
        raise AssertionError(f"(a) FAVOR counts {counts}, want {want} (one launch of each "
                             "half and one (ctx, ksum) sum a layer a step on a rank; the "
                             "fused entry alone in one process)")
    loss_rel = float(np.max(np.abs(r0["losses"] / ref["losses"] - 1)))
    grad_rel = _rel_to_largest(r0, ref, [k for k in ref if k.startswith("grad0/")])
    projs = [k for k in ref if k.endswith("fast_attention.projection")]
    same_proj = len(projs) == SEQ_MLM_DEPTH and all(np.array_equal(r0[k], ref[k])
                                                    for k in projs)
    w_rel = _rel_to_largest(r0, ref, [k for k in ref if k.startswith("w/")
                                      and k not in projs])
    log(f"(a) losses {np.round(ref['losses'], 5).tolist()} (one process); 2 ranks: losses "
        f"within {loss_rel:.2e} relative, step-1 gradients within {grad_rel:.2e} of each "
        f"tensor's largest, final weights within {w_rel:.2e} of each tensor's largest, "
        f"projections after the redraws equal: {same_proj}; the ranks bit-equal; FAVOR "
        f"counts {json.dumps(counts)}; {time.perf_counter() - t0:.1f} s [{card}]")
    if loss_rel > 1e-5 or grad_rel > 1e-3 or not same_proj:
        raise AssertionError("(a) the 2-rank seq steps left the single-process ones")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "weights_rel": w_rel,
            "launches": {"favor_accumulate": SEQ_WORLD * per_step,
                         "favor_apply": SEQ_WORLD * per_step},
            "s": time.perf_counter() - t0}


def phase_favor_split(torch, favor_cuda, dev) -> dict:
    """Phase 20 (a), the entries at one rank's shape: the seam bit-equal to
    the fused entry, each half against its plain version, each timed."""
    from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

    b, h, d, m = PRETRAIN_BATCH, MM_HEADS, MM_DIM_HEAD, 266
    n = (MM_VOCAB + 2) // SEQ_WORLD
    rng = np.random.default_rng(SEED + 6)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, n, d), dtype=np.float32),
                               device=dev) for _ in range(3))
    proj = orthogonal_gaussian_matrix(m, d, generator=torch.Generator().manual_seed(SEED)).to(dev)
    fused = favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
    ctx, ksum = favor_cuda.favor_accumulate_op(k, v, proj)
    seam = favor_cuda.favor_apply_op(q, proj, ctx, ksum)
    torch.cuda.synchronize()
    if not torch.equal(seam, fused):
        raise AssertionError("favor_accumulate then favor_apply differs from the fused "
                             f"entry by {float((seam - fused).abs().max())}")
    p_ctx, p_ksum = favor_cuda.favor_accumulate_plain(k, v, proj)
    acc_err = max(float((ctx - p_ctx).abs().max()), float((ksum - p_ksum).abs().max()))
    acc_worst = max(float((got - want).abs().max()
                          / (FAVOR_ATOL + FAVOR_RTOL * want.abs().max()))
                    for got, want in ((ctx, p_ctx), (ksum, p_ksum)))
    p_out = favor_cuda.favor_apply_plain(q, proj, ctx, ksum)
    diff = (seam - p_out).abs()
    app_err = float(diff.max())
    app_worst = float((diff / (FAVOR_ATOL + FAVOR_RTOL * p_out.abs())).max())
    log(f"favor halves B={b} H={h} N={n} d={d} m={m}: accumulate then apply bit-equal to the "
        f"fused entry; accumulate vs plain max abs err {acc_err:.3g} ({acc_worst:.3g} x "
        f"(atol + rtol max |plain|)), apply vs plain on the same ctx/ksum max abs err "
        f"{app_err:.3g} ({app_worst:.3g} x the elementwise tolerance)")
    if not (acc_worst <= 1.0 and app_worst <= 1.0 and bool(torch.isfinite(seam).all())):
        raise AssertionError("a FAVOR half differs from its plain version")
    del p_ctx, p_ksum, p_out, diff
    calls = {"favor_accumulate": (lambda: favor_cuda.favor_accumulate_op(k, v, proj),
                                  lambda: favor_cuda.favor_accumulate_plain(k, v, proj),
                                  ("favor_accum_kernel", "favor_reduce_kernel")),
             "favor_apply": (lambda: favor_cuda.favor_apply_op(q, proj, ctx, ksum),
                             lambda: favor_cuda.favor_apply_plain(q, proj, ctx, ksum),
                             ("favor_apply_kernel",))}
    # each half: two of the four products, split TF32 (three TF32 products
    # a product); moves two (B, H, N, d) tensors (k and v read, or q read and
    # out written), and proj, ctx and ksum once
    flops = 2 * 2 * b * h * n * d * m + b * h * n * m
    nbytes = 4 * (2 * b * h * n * d + m * d + b * h * m * (d + 1))
    res = {}
    for name, (kernel, plain, symbols) in calls.items():
        ms, host_ms = cuda_ms(torch, kernel, iters=20)
        dev_ms, parts = kernel_line(device_ms(torch, kernel, 10, symbols))
        plain_ms, _ = cuda_ms(torch, plain, iters=5, warmup=1)
        t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"max_abs_err": acc_err if name == "favor_accumulate" else app_err,
                     "ms": ms, "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": None}
        log(f"{name} B={b} H={h} N={n}: {ms:.4f} ms per call (events; host {host_ms:.4f} ms), "
            f"device {dev_ms:.4f} ms ({parts}), plain {plain_ms:.4f} ms, bound "
            f"{res[name]['bound_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP split TF32 "
            f"{t_ops:.4f} ms; {nbytes / 1e9:.3f} GB -> {t_bytes:.4f} ms)")
    fused_ms, _ = cuda_ms(torch, lambda: favor_cuda.fused_generalized_linear_attention(
        q, k, v, proj), iters=20)
    log(f"fused entry at the same local N: {fused_ms:.4f} ms per call (events), against "
        f"{res['favor_accumulate']['ms'] + res['favor_apply']['ms']:.4f} ms for the two "
        "halves in turn")
    res["fused_ms_local_n"] = fused_ms
    return res


def phase_profile_register(torch, port, card, tmp, image, dirs_masks) -> dict:
    """Phase 20 (b): ``--profile-dir`` around the ``register`` command of
    phase 4's model directory over slide 0. A trace whose kernel records
    were lost (see :func:`profiled`) is taken again, at most 3 times."""
    from gridnext_tpu_torch import cli, ingest

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log("== phase 20 (b): --profile-dir around register on the card")
    dev = torch.device("cuda")
    decode = ingest.decode_slide
    ingest.decode_slide = np.load
    try:
        for attempt in range(1, 4):
            trace_dir = os.path.join(tmp, f"profile_{attempt}")
            out = os.path.join(tmp, f"profile_{attempt}.csv")
            gather.launches = 0
            for key in corr.launches:
                corr.launches[key] = 0
            t0 = time.perf_counter()
            cli.main(["--profile-dir", trace_dir, "register", "--model", image["model_dir"],
                      "--images", image["files"][0], "--spaceranger", dirs_masks[0][0],
                      "--out", out, "--device", str(dev)])
            seconds = time.perf_counter() - t0
            launches = {"gather_patches": gather.launches,
                        "fused_hex_corrector_labels": corr.launches["fused_hex_corrector_labels"]}
            files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
            with open(os.path.join(trace_dir, files[0])) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            found = {name: sum(any(sym in kname for sym in KERNEL_SYMBOLS[name])
                               for kname in kernels) for name in launches}
            if all(found.values()) or attempt == 3:
                break
            log(f"trace {attempt} of 3 lost kernel records ({found}), tracing again")
    finally:
        ingest.decode_slide = decode
    n_rows = sum(1 for _ in open(out)) - 1
    log(f"(b) register under --profile-dir: {seconds:.2f} s, {len(events)} trace events "
        f"({os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6:.1f} MB), kernel "
        f"events {json.dumps(found)}, launches {json.dumps(launches)}, {n_rows} CSV rows "
        f"[{card}]")
    if len(files) != 1 or not all(found.values()) or min(launches.values()) <= 0:
        raise AssertionError(f"(b) the trace lacks the gather's or the labels corrector's "
                             f"kernel events ({found}, launches {launches}, files {files})")
    if n_rows != int(dirs_masks[0][1].sum()):
        raise AssertionError(f"(b) {n_rows} CSV rows for {int(dirs_masks[0][1].sum())} spots")
    return {"launches": launches, "kernel_events": found, "s": seconds}


def reference_densenet_state_dict(torch, f_vars, block_config):
    """The reference DenseNet's state dict (its module names,
    densenet.py:100-138 of the reference) of a DenseNet-121's variables in
    the JAX layout: what ``densenet_from_torch`` reads back."""
    params, stats = f_vars["params"], f_vars["batch_stats"]
    sd = {}

    def conv(name, kernel):
        sd[name] = torch.as_tensor(np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)))

    def bn(prefix, p, st):
        for key, val in (("weight", p["scale"]), ("bias", p["bias"]),
                         ("running_mean", st["mean"]), ("running_var", st["var"])):
            sd[f"{prefix}.{key}"] = torch.as_tensor(np.asarray(val))

    conv("features.conv0.weight", params["conv0"]["kernel"])
    bn("features.norm0", params["BatchNorm_0"], stats["BatchNorm_0"])
    layer = trans = 0
    for bi, n_layers in enumerate(block_config, start=1):
        for li in range(1, n_layers + 1):
            pre, name = f"features.denseblock{bi}.denselayer{li}", f"_DenseLayer_{layer}"
            bn(f"{pre}.norm1", params[name]["BatchNorm_0"], stats[name]["BatchNorm_0"])
            conv(f"{pre}.conv1.weight", params[name]["Conv_0"]["kernel"])
            bn(f"{pre}.norm2", params[name]["BatchNorm_1"], stats[name]["BatchNorm_1"])
            conv(f"{pre}.conv2.weight", params[name]["Conv_1"]["kernel"])
            layer += 1
        if bi != len(block_config):
            name = f"_Transition_{trans}"
            bn(f"features.transition{bi}.norm", params[name]["BatchNorm_0"],
               stats[name]["BatchNorm_0"])
            conv(f"features.transition{bi}.conv.weight", params[name]["Conv_0"]["kernel"])
            trans += 1
    bn("features.norm_final", params["BatchNorm_1"], stats["BatchNorm_1"])
    sd["classifier.weight"] = torch.as_tensor(
        np.ascontiguousarray(np.asarray(params["classifier"]["kernel"]).T))
    sd["classifier.bias"] = torch.as_tensor(np.asarray(params["classifier"]["bias"]))
    return sd


def phase_torch_checkpoint(torch, slides, positions, port, variables, meta, card) -> dict:
    """Phase 20 (c): phase 6's DenseNet-121 as a reference-layout ``.pth``,
    read through ``densenet_from_torch`` and registered on slide 0 against
    the ``from_jax`` route."""
    from gridnext_tpu_torch.compat import torch_convert

    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log("== phase 20 (c): a reference-layout DenseNet-121 .pth registered on the card")
    dev = slides.device
    classes = meta["classes"]
    f_vars = {c: variables[c]["patch_classifier"] for c in ("params", "batch_stats")}
    block_config = (6, 12, 24, 16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "densenet_ref.pth")
        torch.save(reference_densenet_state_dict(torch, f_vars, block_config), path)
        size_mb = os.path.getsize(path) / 1e6
        converted = torch_convert.densenet_from_torch(
            torch_convert.read_torch_checkpoint(path), block_config=block_config)
    loaded = {c: {**variables[c], "patch_classifier": converted[c]}
              for c in ("params", "batch_stats")}
    want = modeldir.image_registrar_from_meta(meta, classes, variables, device=dev)(
        slides[0], positions[0])
    reg = modeldir.image_registrar_from_meta(meta, classes, loaded, device=dev)
    gather.launches = 0
    for key in corr.launches:
        corr.launches[key] = 0
    got = reg(slides[0], positions[0])
    torch.cuda.synchronize()
    launches = {"gather_patches": gather.launches,
                "fused_hex_corrector_labels": corr.launches["fused_hex_corrector_labels"]}
    same = bool(np.array_equal(got, want))
    log(f"(c) densenet_ba44-layout .pth of {size_mb:.1f} MB: labels equal to the from_jax "
        f"route's: {same} ({int((want > 0).sum())} spots); launches {json.dumps(launches)} "
        f"[{card}]")
    if not same or min(launches.values()) <= 0:
        raise AssertionError("(c) the reference checkpoint's labels differ from the from_jax "
                             f"route's, or a kernel was not launched ({launches})")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from gridnext_tpu_torch import evaluate, geometry, io, modeldir, models, serving
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.ops import _cuda
    from gridnext_tpu_torch.ops import denseblock_cuda as dense
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
    from gridnext_tpu_torch.ops import patch_gather_cuda as gather

    log("== phase 1: setup")
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _cuda.build()
    for name, info in built.items():
        log(f"built {name}.cu in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(k in line for k in ("registers", "spill", "error", "warning",
                                       "dense_layer_kernel")):
                log(f"  {line.strip()}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    hmma = sass_count(_cuda.library_path("favor"), "HMMA")
    log(f"favor library SASS: {hmma} HMMA (tensor-core) instructions")
    if hmma == 0:
        raise AssertionError("the FAVOR library has no tensor-core instructions")
    hgmma = sass_count(_cuda.library_path("denseblock"), "HGMMA")
    log(f"denseblock library SASS: {hgmma} HGMMA (warpgroup tensor-core) instructions")
    if hgmma == 0:
        raise AssertionError("the dense-block library has no wgmma (HGMMA) instructions")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    _, _, y_px, x_px = lattice(geometry)
    h, w = int(y_px.max() + MARGIN), int(x_px.max() + MARGIN)
    slides = make_slides(torch, N_SLIDES, h, w, dev)
    log(f"{N_SLIDES} slides of {h} x {w} x 3 uint8 ({slides.numel() / 1e9:.2f} GB)")

    res = {"gather_patches": phase_gather(torch, slides, geometry, gather)}
    res.update(phase_corrector(torch, corr, serving, dev))
    port = (geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr)
    with tempfile.TemporaryDirectory() as tmp:   # positions files, Loupe CSV
        launches, reg, positions, masks, batch4 = phase_main_path(torch, slides, port,
                                                                  card, tmp)
    profile_batch(torch, reg, slides, positions)
    del reg

    # DenseNet-121 with random weights from a numpy seed, in the JAX layout
    dn_vars = random_variables(models, from_jax,
                               models.densenet121(num_classes=N_CLASSES), SEED + 4)
    blocks = phase_dense_block(
        torch, dense, {c: dn_vars[c]["patch_classifier"]
                       for c in ("params", "batch_stats")}, dev)
    for b, r in blocks.items():
        log(f"dense block {b}: {json.dumps(r)}")
    res["fused_dense_block"] = blocks[1]          # the kernels line: block 1's shape
    dn_launches, dn_meta = phase_densenet(torch, slides, positions, masks,
                                          port + (dense,), dn_vars, card)
    launches["fused_dense_block"] = dn_launches["fused_dense_block"]
    phase_resize(torch, slides, positions, masks, port, dn_meta, dn_vars)
    torch_ckpt = phase_torch_checkpoint(torch, slides, positions, port, dn_vars, dn_meta, card)
    del dn_vars
    res["fused_generalized_linear_attention"] = phase_favor(torch, favor_cuda, dev)
    launches["fused_generalized_linear_attention"], mm = phase_mm(
        torch, slides, positions, masks, port, card)
    # phase 18's paths, each driven with its counts set to 0 just before and
    # read just after: the served requests and the artifacts' calls
    served = {"serve": {}, "artifact": {}}
    t18 = []
    with tempfile.TemporaryDirectory() as tmp:   # model dirs, slides, caches, CSVs
        dirs_masks, image_dir = phase_register_slides(torch, slides, port, card, tmp, batch4)
        phase_count(torch, port, card, tmp, dirs_masks, dev)
        t18.append(phase_serve(torch, slides, port, card, tmp, dirs_masks, image_dir, batch4,
                               served))
        mesh_c = phase_mesh_register(torch, slides, port, card, image_dir, dirs_masks, batch4)
        profile_reg = phase_profile_register(torch, port, card, tmp, image_dir, dirs_masks)
        del image_dir
    with tempfile.TemporaryDirectory() as tmp:   # HD model dirs, parquets, slides, CSVs
        t0 = time.perf_counter()
        hd = phase_hd(torch, port, card, tmp, dev)
        log(f"phase 12: {time.perf_counter() - t0:.1f} s")
        t18.append(phase_export_dense(torch, port, card, tmp, hd, served))
        del hd
    with tempfile.TemporaryDirectory() as tmp:   # Spaceranger dirs, caches, model dirs
        t0 = time.perf_counter()
        kinds = phase_kinds(torch, slides, masks[0], port, card, tmp, mm)
        log(f"phase 13: {time.perf_counter() - t0:.1f} s")
        t18.append(phase_export_mm(torch, slides, port, card, tmp, kinds, mm, served))
        del kinds
    with tempfile.TemporaryDirectory() as tmp:   # cohort, slides, model dirs, trace
        cohort = phase_train(torch, slides, port, card, tmp, mm)
        evald = phase_eval_distill(torch, port, card, tmp, cohort, mm, dev)
        mesh_b = phase_mesh_ranks(torch, card, tmp, cohort)
    del mm, cohort
    with tempfile.TemporaryDirectory() as tmp:   # cohort, caches, model dirs, CSVs
        tier = phase_count_tier(torch, card, tmp, dev)
        t18.append(phase_serve_count(torch, port, card, tier, dev))
        pretrain = phase_pretrain(torch, card, tmp, tier["dirs"], dev)
        mesh_ad = phase_mesh_count_tier(torch, card, tmp, tier, dev)
    log(f"phase 18: {sum(t18):.1f} s ((a)-(b) {t18[0]:.1f}, (c) {t18[1]:.1f}, (d) "
        f"{t18[2]:.1f}, the count request {t18[3]:.1f}); launches {json.dumps(served)} "
        f"[{card}]")

    # phase 19's paths: (b)'s crops and FAVOR calls on each rank and (c)'s
    # shards ((a) and (d) launch no kernel: train-count crops nothing, PCA is
    # a library call)
    mesh_launches = {"gather_patches": mesh_c["launches"]["gather_patches"]
                     + 2 * mesh_b["gather_launches_per_rank"],
                     "fused_hex_corrector_labels": mesh_c["launches"]["fused_hex_corrector_labels"],
                     "fused_generalized_linear_attention":
                         2 * mesh_b["favor_launches_per_rank"]}
    log(f"phase 19: {json.dumps({'a': mesh_ad['a'], 'b': mesh_b, 'c': mesh_c, 'd': mesh_ad['d']})}"
        f"; launches {json.dumps(mesh_launches)} [{card}]")
    with tempfile.TemporaryDirectory() as tmp:   # the ranks' results
        seq = phase_seq_ranks(torch, card, tmp)
    res.update(phase_favor_split(torch, favor_cuda, dev))
    launches.update(seq["launches"])
    log(f"phase 20: (a) {seq['s']:.1f} s, (b) {profile_reg['s']:.1f} s; (b) launches "
        f"{json.dumps(profile_reg['launches'])}, (c) launches "
        f"{json.dumps(torch_ckpt['launches'])} [{card}]")

    meta = {
        "gather_patches": ("gridnext_tpu_torch/csrc/patch_gather.cu",
                           "gridnext_tpu/ops/patch_gather_pallas.py:143"),
        "fused_hex_corrector": ("gridnext_tpu_torch/csrc/hexcorrector.cu",
                                "gridnext_tpu/ops/hexcorrector_pallas.py:182"),
        "fused_hex_corrector_labels": ("gridnext_tpu_torch/csrc/hexcorrector.cu",
                                       "gridnext_tpu/ops/hexcorrector_pallas.py:197"),
        "fused_dense_block": ("gridnext_tpu_torch/csrc/denseblock.cu",
                              "gridnext_tpu/ops/denseblock_pallas.py:116"),
        "fused_generalized_linear_attention": ("gridnext_tpu_torch/csrc/favor.cu",
                                               "gridnext_tpu/ops/favor_pallas.py:110"),
        # FAVOR's halves, launched apart on a 'seq' axis (phase 20 (a))
        "favor_accumulate": ("gridnext_tpu_torch/csrc/favor.cu",
                             "gridnext_tpu/ops/favor_pallas.py:142"),
        "favor_apply": ("gridnext_tpu_torch/csrc/favor.cu",
                        "gridnext_tpu/ops/favor_pallas.py:161"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "device_ms": res[name]["device_ms"],
                "host_ms": res[name]["host_ms"], "plain_ms": res[name]["plain_ms"],
                "bound_ms": res[name]["bound_ms"], "bound_by": res[name]["bound_by"],
                # one aten::index on the unfold view computes the crop; no
                # single PyTorch call computes the others (the dense block's
                # cuDNN sequence is a yardstick of many calls; FAVOR is not the
                # softmax attention of a fused attention call)
                "library_ms": res[name].get("library_ms")}
               for name, (src, rep) in meta.items()]
    by_name = {k["name"]: k for k in kernels}
    by_name["fused_generalized_linear_attention"]["ms_local_n_seq"] = res["fused_ms_local_n"]
    # phase 16's path: pretrain-scbert's FAVOR calls, its counts set to 0 just
    # before the command and read just after
    by_name["fused_generalized_linear_attention"]["launches_pretrain_scbert"] = \
        pretrain["pretrain"]["favor_launches"]
    # phase 17's paths: every evaluate and distill command's launches, each
    # command's counts set to 0 just before it and read just after
    for k in kernels:
        if k["name"] in ("gather_patches", "fused_hex_corrector_labels",
                         "fused_generalized_linear_attention"):
            for command in ("evaluate", "distill"):
                k[f"launches_{command}"] = evald["launches"][command][k["name"]]
            # phase 18's paths: the served requests and the artifacts' calls
            for path in ("serve", "artifact"):
                k[f"launches_{path}"] = served[path].get(k["name"], 0)
            # phase 19's paths: the mesh's ranks and shards
            k["launches_mesh"] = mesh_launches[k["name"]]
        # phase 20 (b)'s and (c)'s paths: the traced command, the reference .pth
        if k["name"] in ("gather_patches", "fused_hex_corrector_labels"):
            k["launches_profile_register"] = profile_reg["launches"][k["name"]]
            k["launches_torch_checkpoint"] = torch_ckpt["launches"][k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
