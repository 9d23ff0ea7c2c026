"""Chip smoke test of the rafiki_tpu_torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero). Phases 7
and 11, which launch no attention kernel, run on a thread beside the
kernel build of phase 1, and phase 2 starts once they are done; phase
19 and phase 9's drill 9d run on threads beside phase 18 (each counts its
launches from its children's exit lines, and they share no store, port,
ring or log; phase 18's card-memory readings then include theirs). The
ViT-B/16 and BERT-base trials of phases 3, 5, 6, 8a and 17 fit with no
per-epoch checkpoint (nothing there reads one; phase 9 drills the
checkpoint with the templates as shipped).
Each phase's time is printed (``chip_smoke: phase N took ...``):

1. header: the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the kernel build (one nvcc per source, started together,
   sm_90a, from ``rafiki_tpu_torch/ops/csrc/``, into
   ``build/rafiki_tpu_torch/``) and the ptxas register/shared-memory report
   of each kernel's main-path instantiation;
2. kernels: each kernel against its plain PyTorch version on the same
   seeded inputs, at the main paths' shapes and at edge cases, with
   device times (CUDA events around queued back-to-back calls) beside the
   bound and PyTorch's own call for the same function: K1 (flash_fwd) at
   the serving shapes, contiguous and on the projection's strided views,
   K1 with the LSE (flash_fwd_lse), K2 (flash_bwd_dq) and K3
   (flash_bwd_dkv) at the training shape, contiguous and on the
   projection's strided views; K2 and K3 at every head dim, at the ragged,
   causal (Sq<Skv) and dead-row cases and on strided views (the same bits
   as contiguous copies); each kernel's achieved TB/s and share of its
   bound;
3. train: a seeded synthetic 10-class image dataset written as ``.npz``,
   and a 2-trial ViT-B/16 train job through ``TrainWorker`` (GP advisor,
   database, ``TorchViT.train`` -> ``DataParallelTrainer.fit`` with AdamW,
   ``evaluate``, params artifact); every trial COMPLETED with a finite
   score, parameters moved, and the kernels' launches counted against 12
   per train step (K1 with the LSE, K2, K3) and 12 per evaluate forward
   (K1); one train step through the kernels against one through plain
   attention, loss and every parameter's gradient; the step's time at
   batch 64 and 128, and a kernel profile of one step;
4. serve: the two trials the train job produced, served through
   ``InferenceWorker`` -> ``Predictor`` -> ``PredictorServer``; ``POST
   /predict`` answers are checked against the two models' plain-attention
   forward on the card, and every kernel's launch count against the
   number of bucketed forwards (K1 12 a forward, the others none); then
   where a request's time goes (one forward per
   call and on the card, and a kernel profile of the bucket-64 forward,
   beside the same forward with q, k, v copied before K1);
5. stack: the same cycle through the entry points a user calls. The
   ``AdminServer`` starts in this process (SQLite store under
   ``build/chip_smoke/``); the ``Client`` logs in as the superadmin,
   uploads ``templates/torch_vit.py`` as bytes (enforce verification),
   runs a 2-trial train job (``CHIP_COUNT=1``) on phase 3's dataset and
   waits for STOPPED: 2 COMPLETED trials with finite scores, the train
   service granted cuda:0, K1-LSE, K2 and K3 launched 12 times a step and
   K1 12 times an evaluate. Then an inference job of the two trials (both
   workers on cuda:0), ``Client.predict`` on ``/predict/<app>`` with 1
   and 8 images (JSON) against the plain-attention ensemble of the
   trials' parameters (the first as ``Client.download_trial_params``
   returns it, the other as the admin reads it), and K1 launched 12
   times a bucketed forward. Printed: the job's wall time and each
   trial's set-up, beside phase 3's direct job (which ran first, on a
   cold process), the p50 of ``/predict/<app>`` on the admin door beside
   a ``PredictorServer`` on the same job's ``Predictor``, the two doors
   taking the same JSON bodies in turns, and the parameter download's
   time and bytes with the verified read's share. (``python -m
   rafiki_tpu_torch.admin`` booting, answering ``GET /`` and a login and
   exiting 0 on SIGTERM is phase 18b's, three boots of it);
6. process: the cycle of phase 5 under ``RAFIKI_PLACEMENT=process``
   (store ``build/chip_smoke/process.sqlite3``, the children's logs in
   ``build/chip_smoke/process_logs/``). The shm ring is chosen from
   ``df -B1 /dev/shm`` (16 MiB when its 3 rings fit in 80% of the free
   space) and printed. The 2-trial job runs in a train child granted the
   card through ``CUDA_VISIBLE_DEVICES``, whose advisor is the admin's
   REST door; both trials COMPLETED with finite scores, their rows
   written by the child, and none of this process's kernel counts moved.
   Then both trials are served by two children over the rings, and a
   second admin (thread placement) serves the same trials' artifacts:
   ``Client.predict`` of 1 and 8 images held within 0.05 p + 1e-5 of the
   plain-attention ensemble, and the same JSON bodies timed on both
   admin doors in turns. Printed: the job's wall time beside phase 5's
   and where it went (child start-up, each trial's set-up and epochs),
   each child's spawn to RUNNING split into interpreter and package
   import, torch import, CUDA init, kernel library load and the rest,
   the deploy time, and the p50 of each door. Each child's launches come
   from its exit line: the train child K1-LSE, K2 and K3 12 a step and K1
   12 an evaluate, each serving child K1 12 a bucketed forward. After the
   stop no child is alive and no ring of the broker is left in /dev/shm.
7. zoo: the image-classification twins. 7a: ``test_model_class`` of each
   of the six (``TorchFeedForward``, ``TorchCnn``, ``TorchVgg16``,
   ``TorchResNet``, ``NpDecisionTree``, ``NpLinearSvm``) on cuda:0, knobs
   from the port's advisor, on a seeded synthetic set of 512 train and
   128 test images (32x32x3) written as image zips. 7b: a synthetic set
   of CIFAR-10's shape at 1/10 of its size (5,000 + 1,000 images,
   32x32x3, 10 classes, a prototype a class plus noise; cut for time from
   CIFAR-10's 50,000 + 10,000) written as image zips by the port's PNG
   writer; ``TorchResNet`` with ``depth`` fixed to ResNet-50 and one
   epoch uploaded through ``Client`` (enforce), a 2-trial job
   (``CHIP_COUNT=1``, the GP over the learning rate and the batch size),
   both trials COMPLETED above chance; an inference job of both,
   ``Client.predict`` of 8 images within 1e-3 of the mean of the two
   trials' own ``predict`` on the card, each image alone within 2e-2 of
   its row in the batch; then 10 timed JSON requests of 1 and of 64
   images. Printed: the job's wall time, each trial's split (dataset read
   and decode, parameter init, upload, epochs, evaluate, artifact write),
   the deploy time, the p50s, and the train step at the best trial's
   batch, per call, on the card and by kernel. No attention kernel is on
   this path: every count must read 0.
8. text. 8a: an SST-2-shaped synthetic corpus (2,300 + 1,821 sentences of
   5-40 words, two disjoint pools; the train set cut for time from
   SST-2's 6,920) written as corpus zips; ``TorchBert``
   at BERT-base's widths (12 x 768, 12 heads, vocabulary 30,522, 128
   tokens, one epoch) uploaded through ``Client`` (enforce), a 2-trial job
   (GP over the learning rate and the batch size), both trials above
   chance, K1-LSE, K2 and K3 launched 12 times a step and K1 12 times an
   evaluate forward; an inference job of both, ``Client.predict`` of 8
   sentences within 1e-3 of the trials' mean and within 0.05 p + 1e-5 of
   the plain-attention forward, K1 12 times a bucketed forward; p50 of
   ``/predict/sst2`` for 1 and 64 sentences; one train step through the
   kernels against plain attention (phase 3's tolerances) and the step's
   time and profile. 8b: ``TorchGenLM`` at ``LMConfig``'s defaults
   (vocabulary 32,000, 2,048 positions, 12 x 768, 12 heads, causal)
   uploaded under ``TEXT_GENERATION``, trained 4 Adam steps on (8, 512)
   through ``Client`` (the causal K1-LSE, K2, K3 12 times a step), one
   step held against plain attention; served on its own door
   (``RAFIKI_PREDICTOR_PORTS=1``) to 8 concurrent ``Client.generate``
   streams of 64 tokens (prompts of 128-512 tokens, half sharing a
   256-token prefix): greedy as JSON and as v3 frames, sampled twice with
   fixed seeds, greedy on the ring layout, sampled with a pool too small
   for the streams (preemption). Greedy streams equal the argmax of the
   f32 plain-attention forward on the card, and sampled ones its draws
   under the same keys, up to each stream's first near tie; the other
   passes equal them as far; prefix-cache hits > 0; no slot or page
   left; no attention kernel launched while serving. Printed: time to
   first token p50/p95, tokens/s, the decode step per call and its
   kernels, the KV pool's bytes.

9. trial loop: the seconds and bytes of one ViT-B/16 + AdamW checkpoint
   write and of its restore onto the card, timed directly. Then four
   drills through ``Client`` -> ``AdminServer`` -> ``Admin``, each with
   a store of its own under ``build/chip_smoke/`` and a twin of
   ``TorchViT`` at full width whose learning rate, batch size and epochs
   suit it. 9a: every trial of a job (batch 2,048 of a 2,048-image set
   written with ``np.savez``) raises the allocator's own
   ``OutOfMemoryError``; with ``RAFIKI_TRIAL_QUARANTINE_K=2`` and
   ``RAFIKI_TRIAL_FAULT_LIMIT=3`` each trial is ERRORED ``USER`` with its
   detail, the advisor's infeasible count rises, the signature is
   quarantined after 2, the third fault errors the job with the
   fail-fast reason and stops its worker, and ``memory_allocated``
   returns within 64 MiB of its level before the job. 9b: ASHA
   (``EARLY_STOP``, eta 2, 3 trials of 2 epochs on phase 3's set) with
   ``RAFIKI_CHAOS=site=trial;action=error;times=1``: the first trial
   absorbs the INFRA fault at ``attempt`` 1 in its own row, all 3
   COMPLETED, at least one stopped at a rung, and every keep/stop verdict
   equal to ``AshaScheduler`` replayed on the logged losses. 9c:
   ``TRIAL_TIMEOUT_S`` (9b's first report plus 1.5 of its epochs) stops
   an 8-epoch trial at the first epoch boundary past it (9b and 9c fit
   with no per-epoch checkpoint; 9d drills it). 9d: under
   ``RAFIKI_PLACEMENT=process`` the train child is SIGKILLed once the
   second trial's checkpoint exists; the
   placement starts it again under the same service id, it resumes that
   trial from its checkpoint under its id and knobs, the admin's advisor
   session survived (``replay_feedback`` returned False), the job counts
   2 trials and no checkpoint is left. Launches: 12 a step and an
   evaluate in 9b-9d (the restarted child's exit line in 9d), none of
   K1, K2, K3 in 9a. Printed: each drill's wall time, each trial's
   epochs, attempt, kind and score, 9b's epoch, the child's restart
   time.

10. several cards, on every visible card up to 4 (``n``; on one card the
   same runs at a grant of one, and says so). 10a: this process is rank
   0 of a data group over the ``n`` cards (``parallel/ranks.py``: a
   follower process a card, NCCL, its INFO lines under
   ``build/chip_smoke/nccl/``): each follower's start-up and the group's,
   the transport NCCL chose, K1, K1-LSE, K2 and K3 against their plain
   versions on every card, one ViT-B/16 step (SGD) over a global batch
   of 64 a card against one card's step over the same batch (the loss
   within 1e-3 relative, each leaf's update within phase 3's step
   tolerance, the same weights on every rank, K1-LSE, K2 and K3 12 times
   on each), the step's time a call and on the card at 1 card x 64 and
   n cards x 64, the all-reduce of ViT-B/16's gradients (median of 7,
   bus bandwidth), and phase 7's ResNet-50 step at 128 a card on one
   card (ATen's fused batch norm) and on n (BatchNorm's moments over the
   ranks). 10b: through ``Client`` under thread placement, a
   ``TorchViT`` twin with ``batch_size`` fixed to 64 n, a 2-trial job
   with ``CHIP_COUNT = CHIPS_PER_TRIAL = n`` on 512 n synthetic images
   (both COMPLETED with a score; every rank K1-LSE, K2 and K3 12 times a
   step and K1 12 times an evaluate: the followers' exit lines, which fd
   2 sends to ``build/chip_smoke/cards_ranks.log``), then the best trial
   served with ``CHIPS_PER_WORKER = n``: ``Client.predict`` of 1 and 8
   images equal to the same trial on one card (argmax, unless a near tie,
   and every probability within 1e-3), ``/predict`` p50 at 1, 64 and 64 n
   images on the job's door (each request split over the ranks, each
   answering its part alone), K1 12 times a bucketed forward on every
   serving rank, and nothing left behind (no follower alive, no default
   process group, no new ``/dev/shm`` entry).

11. generation and tagging (no attention kernel on either path: every
   count must read 0). 11a: a seeded CIFAR-shaped ``.npz`` set (4,096 +
   512 images, 32x32x3, phase 7's prototypes); one D step (WGAN-GP with
   the penalty's double backward) and one G step of the Progressive GAN
   at ``TorchProGan``'s widths (latent 128, 128 feature maps, 4 stages)
   at mb 16, lod 1.5, from the same weights and ``jax.random`` draws:
   f32 on the card against f32 on the CPU (losses 1e-4 relative, each
   leaf 1e-3 relative L2), bf16 on the card against that f32 step
   (losses 2e-2, each leaf 5e-2 or 1.5 times the CPU's bf16 step,
   whichever is larger); the f32 step over every visible card up to 4
   against one card's (``minibatch_stddev`` over the global batch;
   phase 10's tolerances); then a 2-trial ``TorchProGan`` job through
   ``Client`` (1 kimg each, lod 3 -> 0; the minibatch fixed at 16),
   served: ``/predict`` of
   ``[[4, 4, 16], [2, 2, 4]]`` writes (128, 128, 3) and (64, 64, 3)
   uint8 grids, each within 1 of a trial's own ``generate`` at seeds
   1000 + i; the D and G steps' times and a profile of the D step.
   11b: a seeded tagged corpus (4,000 + 500 sentences of 5-48 tokens,
   5,000 words, 45 tags) as corpus zips; one ``TorchBiLstm`` step at its
   widest knobs, f32 on the card against the CPU (loss 1e-4, leaves
   1e-3), its time and profile; a 2-trial ``TorchBiLstm`` job (batch
   fixed at 128, 4 epochs: the template's 10 cut for time) and a 1-trial
   ``NpBigramHmm`` job (score >= 0.9) through ``Client``, each deployed
   and tagging 8 sentences, a tag a token. Printed: the job times, each trial's knobs, score and split,
   kimg/s, the p50s.

12. serving control, on phase 8a's two trained BERT-base trials (its
   store, reopened). 12a: K1 under ``torch.func.vmap`` over the T=2
   trials (B=64, H=12, S=128, Dh=64, bf16, on the stacked projection's
   views) against its plain version for each trial (phase 2's
   tolerance), ONE launch a call, timed beside two K1 calls at B=64, the
   plain version, SDPA and the bound (whether the fold copied is
   printed); K1's line gets this shape under ``shapes``. 12b: the job
   deployed with ``ENSEMBLE_FUSED`` through ``Client`` (per-job doors
   on): one worker holding both trials, ``fused_dispatch`` true in its
   stats row, K1 12 times a bucketed fused forward (not 24), the answers
   to 8 sentences against 8a's unfused ensemble and its trials' mean
   (the ``PROB_RTOL``/``PROB_ATOL`` rule) and ``predict_direct``'s
   against the admin door's; p50 of 8 sentences through the admin door
   and through ``Client.predict_direct`` beside 8a's unfused p50. 12c:
   on the job's own door, a burst of 16 concurrent requests at
   ``RAFIKI_PREDICT_MAX_INFLIGHT=2``: some 503s, every admitted request
   answered, admitted + shed = 16 in ``/healthz``; at a cap of 1, one
   request held behind 192 queued queries and five more one at a time:
   a lone 503's time; then 192 queries put on the worker's queue and a
   request due in 1 ms: 429 with ``Retry-After``. 12d: ``RAFIKI_PREDICT_CACHE=1``: 10 requests of new
   sentences through the admin door (misses), the same 10 again: 80
   hits, no K1 launch, the same answers; both p50s.

13. generation, the rest, on phase 8b's trained LM and store, through
   an admin whose inventory lists the card once a replica. 13a: a draft
   (``TorchGenLMDraft``: vocab 32,000, 2,048 positions, 2 x 384, 6
   heads) trained through ``Client`` as a one-trial ``TEXT_GENERATION``
   job (40 Adam steps on (8, 512) of 8b's pattern): K1 2 launches and
   K1-LSE, K2, K3 80 each; each kernel against its plain version at its
   shape (causal, B=8, H=6, S=512, Dh=64). 13b: 8b's trial deployed with
   ``GEN_DRAFT_TRIAL`` (two replicas): 8b's 8 prompts greedy, 64 tokens,
   equal to 8b's plain greedy streams up to their first top-2 gap under
   ``TIE_GAP``; ``gen_spec_on`` and the spec counters in the stats rows;
   the acceptance rate, time to first token and tokens/s beside 8b's
   plain pass; one draft burst and one verify timed (host clock, CUDA
   events, kernel profile). 13c: 8 sampled streams (seeds 1..8) twice,
   equal; one captured sampled round's ``paged_verify_step`` on the card
   against a CPU f32 copy, equal where its decisions clear
   ``DRAW_MARGIN``. 13d: a ``site=generate`` ``error`` rule on one
   replica's draft: that replica's row has ``gen_spec_degraded``, the
   streams finish with 13b's tokens. 13e: 8b's trial at three replicas,
   no draft, one-shot prefill, a 2-s stall window: 8 sampled streams, a
   ``site=worker``
   ``drop`` kill of the replica holding the most after their first
   deltas, then a ``site=worker`` ``error`` retirement of another; every
   stream finishes with 8b's uninterrupted tokens (``compared_sampled``'s
   margins) and the door's ``resumes_worker_death`` and
   ``resumes_migrating`` count the streams each victim held; the time
   from each rule to the resumed tokens. No kernel is launched serving.

14. populations and int8 serving. 14a: 11a's images scaled to [-1, 1]
   (``build/chip_smoke/pop/``); ``TorchCnn``'s network at its widest
   knobs (3 stages, 64 base channels, 32x32x3) as a population of K=4
   learning rates (``PopulationTrainer``, AdamW): one step on 64 rows,
   f32 on the card against f32 on the CPU (member losses 1e-4 relative,
   each member's gradient leaf 1e-3 relative L2) and bf16 on the card
   against it (2e-2, 5e-2); the f32 step at batch 256 over every visible
   card up to 4 against one card's (phase 10's tolerances); each member's
   f32 gradients against its own ``DataParallelTrainer`` step (1e-3), its
   first update over the elements whose two gradients agree in sign past
   1e-6 (1e-4, on at least 0.75 of each leaf), and its epoch loss against
   its own one-epoch fit (2e-2); one bf16
   population epoch at batch 256, the population step's time a call, on
   the card and by kernel beside K scalar steps. 14b: a ``TorchCnn`` twin
   (3 stages, 64 channels, batch 128, 2 epochs fixed) through ``Client``,
   8 trials at ``TRIAL_VMAP_K`` 4: ``FIT_STATS["member_counts"]`` and
   ``["completed_member_counts"]`` read ``[4, 4]``, each batch's lead row
   logs every member's loss each epoch and no other row logs an epoch
   (a batch re-run as scalar trials fails here), 8 rows COMPLETED with
   their own scores and parameters, the
   best served and answering as their own ``predict``; the job's wall
   time beside a 4-trial scalar twin (``RAFIKI_TRIAL_VMAP=0``), as trials
   per GPU-hour. 14c: a one-trial ``TorchCnnPopulation`` job
   (population 8) through ``Client``, its winner served. No attention
   kernel on 14a-c. 14d: phase 8a's two BERT-base trials, from its
   store, under ``RAFIKI_SERVE_INT8=1`` (the trainer cache cleared
   first): solo, K1 12 times a bucketed forward, the answers to 8
   sentences against 8a's bf16 answers by JAX's rule (argmax agreement
   >= 0.99, within 0.15) and nearer the same trials' int8 forward on the
   CPU; ``quantized_bytes`` beside the bf16 bytes, the device memory
   the job's workers hold, p50 beside 8a's and 12b's; then ``ENSEMBLE_FUSED``: K1 12 times a fused forward, each
   trial's answer in the int8 stack against its solo int8 answer.

15. model-parallel training, on every visible card up to 4 (``n``; on
   one card every leg runs on a mesh of one, and says so). 15a:
   ``parallel/dryrun.py``'s ``dryrun_multichip(n, full=True)``, the entry
   point a user calls, one process a card (NCCL): ViT-B/16 (224/16, 768
   x 12, 12 heads) over dp x tp x sp, 3 AdamW steps on a seeded batch of
   64; the LM at ``LMConfig``'s widths (768 x 12, 12 heads, vocabulary
   32,000) with 8 experts a layer (capacity factor 1.25) over pp x dp x
   ep on (8, 512) tokens; the LM with ring attention over dp x sp at S =
   2,048 (4 rows); the LM with GPipe (12 layers, 4 microbatches) over pp
   x dp on (8, 512); ViT-B/16's tensor-split predict. A line a leg and
   the OK line; every rank's launches a leg held to its count (K1-LSE,
   K2 and K3 once a layer a step: every layer on every rank, a stage's
   layers once a microbatch under GPipe, none under ring attention over
   several cards; K1 once a layer in the predict). 15b: on n > 1 cards
   rank 0 first takes each leg's step alone (one card: bf16 and f32,
   SGD at lr 1 from the same parameters and global batch), then every
   rank the n-card bf16 step: the loss within 1e-3 relative of one
   card's (or 1.5 times its distance from f32), each gathered leaf
   (less its gradient) no farther from the f32 step than 1.5 times one
   card's; each leg's AdamW step timed on one card and on n (median of
   3, host clock a call); ViT-B/16 at ``remat="dots"`` and ``"full"``,
   the same SGD step as the n-card one from the same parameters, batch
   and key: its loss within 1e-6 relative of the step without remat and
   each leaf's update within 1e-3 of its gradient's norm and two f32
   ulps an element (K1-LSE twice a layer, K2 and K3 once);
   K1, K1-LSE, K2 and K3 against their plain versions on every card at
   every leg's shapes (local heads, sequence-sharded queries against
   gathered keys, a microbatch). Phase 15 alone: ``python3 -c "import
   chip_smoke as cs; cs.model_parallel_only()"``.

16. fleet operations, on phase 8a's two trained BERT-base trials (its
   store, reopened), the job deployed serving its best trial
   (``INFERENCE_MAX_BEST_TRIALS=1``, one replica) on its own door.
   16a: ``Client.update_inference_job`` to the other trial under a steady
   stream of 8-sentence requests from a client thread (judge window 2 s,
   3 canary requests): DONE, no request failed, a second update while it
   is live answers 409, the serving version is 1 and the result cache
   holds no entry of version 0 (8 filled before), the new replica ran K1
   12 times a batch and the answers equal that trial's own from 8a (the
   ``PROB_RTOL``/``PROB_ATOL`` rule); then an update back with the
   ``deploy`` chaos site armed: ROLLED_BACK with its reason, no request
   failed, the answers still the incumbent's. 16b
   (``RAFIKI_AUTOSCALE=1``, a 0.25 s tick, a 3 s window, short
   cooldowns, at most 2 replicas): 8 clients flood the job's door at an
   in-flight cap of 2; the loop scales up by one replica ("sustained
   shed", its signals in the event; on one card the new replica shares
   the card: the floor of 1 lends none); after 16c, idle drains it back
   to one replica, every request sent meanwhile answered. 16c
   (``RAFIKI_AUTOSCALE_WARM_POOL=1``): a standby placed and warmed (K1 in
   its warm-up, 12 a bucket), never routed; a routed replica killed under
   a steady stream (its worker stopped, then the ERRORED verdict): the
   standby promoted, no client error; the next tick places a new
   standby. 16d, on two or more cards only (on one, a line says so): a
   scale-up borrows an idle card above the floor (an exclusive grant),
   and a train job of one-card ``TorchFeedForward`` trials that cannot
   allocate reclaims it (the borrowed replica drained, the loan
   returned); 8b's LM served under ``CHIPS_PER_WORKER=2`` (grant [0, 1])
   streams 8b's greedy tokens up to their held positions, its memory on
   cuda:0 alone. Printed: the deploy times of the canary, the scaled-up
   replica and the standby, the rollout's wall time, the p50 of 8
   sentences before, during and after it, the time from the kill to the
   promotion. Phase 16 with what it stands on: ``python3 -c "import
   chip_smoke as cs; cs.fleet_only()"`` (phase 8, then 16; 16d on four
   cards).

17. drift and sandbox, on phase 5's store (its ViT-B/16 template, 224/16,
   768 x 12, on phase 3's images): a one-trial job at ``CHIP_COUNT`` 0
   (so its retrain shares the card its serving replica holds), deployed
   under ``RAFIKI_DRIFT=1`` (1-s windows of 8 samples, a retrain of
   one trial, ticks driven here) and a client thread calling
   ``Admin.predict`` with one image at a time. 17a: a baseline frozen on
   4 test images, then the traffic shifted to the training images: a
   novelty verdict and exactly one warm-started retrain, a ViT-B/16
   trial trained in a sandbox child on the card (``RAFIKI_SANDBOX=1``
   while it trains: the child's report holds its euid, the uid drop, its
   devices, the two kernel libraries it loaded read-only, and K1 12,
   K1-LSE, K2 and K3 12 a step); then the branch the scores decide: the
   rollout to DONE (the candidate serving) or ``candidate_worse`` and a
   cooldown with no rollout, with no failed request either way; when it
   is the latter, a narrow leg (ViT 2 x 64 at 224/16, its score set
   through the environment as the drift fixture's) rolls its candidate
   out to DONE under the same load. The ``drift`` chaos site at the
   launch: a retry, then PARKED with no retrain launched, and
   ``Client.ack_drift`` re-arms the loop. 17b: the retrain's version
   deployed through ``Client.create_inference_job`` under
   ``RAFIKI_SANDBOX=1``, its replica serving the candidate from a
   ``SandboxedModelServer`` child (K1 in the child, its report), its
   ``Client.predict`` answers held against the same parameters'
   in-process forward (the ``PROB_RTOL``/``PROB_ATOL`` rule); the retrain
   child's report read from the trial's log; a mute child killed as STALL
   (``RAFIKI_TRIAL_STALL_S=3``); ``ENSEMBLE_FUSED`` under the sandbox
   refused with ``ServiceDeploymentError`` and the job ERRORED. Phase 17
   with what it stands on: ``python3 -c "import chip_smoke as cs;
   cs.drift_sandbox_only()"`` (the dataset, phase 5, then 17).

18. control-plane HA and crash recovery, on phase 3's images, every admin
   a process of its own over one SQLite store under ``build/chip_smoke/
   ha/`` with ``RAFIKI_PLACEMENT=process``. 18a: a leader (``python -m
   rafiki_tpu_torch.admin`` under ``RAFIKI_ADMIN_HA=1``, a lease TTL of
   3 s) and a hot standby (a ``python -c`` main of ``StandbyAdmin`` and
   ``AdminServer``), a ``Client`` over both addresses (which the train
   child's own client walks too, ``RAFIKI_ADMIN_ADDRS``); a ViT-B/16
   (224/16, 768 x 12) job of 2 trials of 1 epoch at batch 64 in one
   process-placed train child (``CHIPS_PER_TRIAL=2`` on two or more
   cards). After the first epoch's report the leader is SIGSTOPped: the
   standby promotes at epoch 2, its recovery adopts the child by pid (the
   report ``adopted`` 1, the adoption's grant in its log); the leader is
   SIGCONTed and its write, and an advisor route, answer the
   standby-style 503 with the new leader's address (``StaleEpochError``),
   landing nothing; then SIGKILLed. Every call the child's client walked
   (its log) landed on the promoted leader, the first an advisor call.
   The child, reparented, trains on and finishes: the job
   STOPPED with 2 COMPLETED trials, no client call failed once
   ``wait_until_admin_ready`` returned; its launches (K1-LSE, K2, K3 12 a
   step; K1 12 an evaluate) read from its log at the promotion (SIGUSR1)
   and at its exit, some after the promotion; the card's memory before
   the stop, after the adoption and after the trial's end. 18b: an admin
   without HA serves the job (one replica in a serving child) and
   answers 8 images; it is SIGKILLed and booted again on its port; the
   dead admin's serving child is gone (its watchdog stops it on
   reparenting; a survivor would be fenced by recovery), the job
   terminal, the recovery report and the ``/dev/shm`` bytes the dead
   admin left under its broker's prefix printed (then removed: only
   those names); the client redeploys and the same
   8 images get answers within the ``PROB_RTOL``/``PROB_ATOL`` rule of
   the first (K1 in the new replica). Phase 18 with what it stands on:
   ``python3 -c "import chip_smoke as cs; cs.ha_only()"``.

19. hosts and agents, on phase 3's images: two agent processes (``python
   -m rafiki_tpu_torch.placement.agent``, a key, the one card listed by
   both; on several cards disjoint sets) and an admin process in hosts
   mode (``RAFIKI_PLACEMENT=hosts``, ``RAFIKI_ADMIN_HA=1``, a 0.5-s
   heartbeat) over one store under ``build/chip_smoke/hosts/``. 19a: a
   ViT-B/16 (224/16, 768 x 12) job of two models of one trial of 1 epoch
   at batch 64, ``CHIP_COUNT`` 2: the least-loaded choice puts one train
   child on each agent (each a child of its agent's process, from the
   agents' ``/inventory``); both trials COMPLETED, and each child's exit
   line reads K1 12 (its evaluate) and K1-LSE, K2, K3 96 (8 steps). 19b:
   the job deployed, one replica a trial, one on each agent; 8 images
   through the admin door cross ``FleetBroker``, ``HttpWorkerQueue`` and
   ``/predict_relay`` into each agent's shm rings: every relay a binary
   frame (the agents' relay counts), the answers within the
   ``PROB_RTOL``/``PROB_ATOL`` rule of the in-process plain-attention
   ensemble, the relayed p50 beside phase 5's admin door. 19c: one
   agent's process group SIGKILLed under a one-image load: the admin's
   DOWN verdict (its log), its relay queue evicted, its replica
   ERRORED, no request failed after the verdict, the survivor's answers
   against its trial's forward; the agent started again on its address
   rejoins. 19d: the admin SIGKILLed and booted again: the agents live
   on, recovery (epoch 2) probes both, adopts the surviving replica
   (same pid, no new serving row), the same images get the same answers,
   and a stop carrying epoch 1 is refused 412 by both agents. Each
   serving child's exit line reads K1 only. 19b also sends one sampled
   one-image request (``X-Rafiki-Trace``) to the job's own door
   (``RAFIKI_PREDICTOR_PORTS=1``): its exemplar holds the door's spans
   and the agents' (queue wait, decode, assembly, forward), grafted from
   their ``trace_spans``; each agent's ``GET /metrics`` parses. Phase 19
   with what it stands on: ``python3 -c "import chip_smoke as cs;
   cs.hosts_only()"``.

20. observability, on phase 3's images, a store under
   ``build/chip_smoke/observability/``. 20a: a one-trial ViT-B/16 job (1
   epoch of 512 images at batch 64) through the admin under
   ``RAFIKI_PROFILE=1``: the trial's Chrome trace
   (``logs/profiles/trial-<id>-<pid>.json``, ``torch.profiler`` with the
   CUDA activity) holds K1-LSE, K2 and K3 by their kernels' names, each
   as many times as its wrapper launched it (12 a step), and K1 never;
   each one's device time summed from the profile is printed beside
   phase 2's CUDA-event time; ``get_trial_trace`` returns its propose,
   train, evaluate and persist_params spans. 20b: that trial served by
   one child under process placement with ``RAFIKI_TRACE_SAMPLE=1``: 8
   one-image ``.npy`` requests with an ``X-Rafiki-Trace`` header at the
   job's door, over the shm rings; each header echoed, each exemplar
   holding admission_wait, queue_wait, codec_decode, batch_assembly,
   model_forward and respond, summing to 0.3-1.3x the request's wall
   time; the child's K1 12 a forward (warm-up buckets and the 8). 20c:
   ``/metrics`` of the admin's door and of the job's door parsed with
   ``parse_prometheus``, every metric name the JAX package publishes
   present, the door's admitted, served and traced counts 8; every
   section of ``/fleet/health``. Phase 20 with what it stands on:
   ``python3 -c "import chip_smoke as cs; cs.observability_only()"``.

The line before the last is ``{"kernels": [...]}``, each kernel's
``launches`` from phase 5 and ``launches_by_path`` from every path; the
last is ``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"  # dataset and params (ignored by git)
TEMPLATE = REPO / "rafiki_tpu_torch" / "templates" / "torch_vit.py"
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: bf16 outputs are rounded to bf16 (2^-8
# relative of O(1) values), serving's K1 rounds P to bf16 before P V and K3
# before P^T dO (the training K1's P V and the dS products are split into
# two bf16 products, f32 to ~2^-17); f32 differs by summation order only.
# Gradients are not O(1): their error is taken relative to max(1, max|ref|)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# K2's delta = rowsum(dO o O) against PyTorch's: f32 sums of Dh products
# in another order, relative to max(1, max |delta|)
DELTA_TOL = 1e-5
DEPTH = 12  # ViT-B/16 blocks: one launch of each attention kernel per block
# served probabilities vs the plain-attention forward: both run bf16
# through 12 blocks and differ where bf16 rounds (the kernel keeps PV in
# f32, mha_reference rounds p to bf16), so the logits differ by O(1e-2)
# and each p by that share of itself: |dp| <= PROB_RTOL * p + PROB_ATOL.
# Over 1000 classes a p is ~1e-3, so an absolute bound alone would pass a
# wrong answer
PROB_RTOL = 5e-2
PROB_ATOL = 1e-5
# one train step through the kernels vs through plain attention, from the
# same weights and batch: the two bf16 paths round at different places in
# 12 blocks forward and backward (2^-8 relative per rounding). The loss
# within 1e-2; each parameter's gradient within 1e-2 of its L2 norm, but
# the q/k projections': at initialization their gradient is a small
# difference (dP - delta over nearly uniform attention), and each bf16
# path lands ~5% of its norm from an f32 run there (CPU measurement at
# ViT-B/16 width), so within 1e-1
LOSS_ATOL = 1e-2
GRAD_RTOL = 1e-2
QK_GRAD_RTOL = 1e-1
QK_LEAVES = ("attn.wq", "attn.wk")
# one bf16 step of BERT-base or the LM through the kernels, held against an
# f32 step through plain attention: at BERT-base's initialization bf16
# rounding alone moves every gradient ~10% from f32 whichever attention
# runs (each sentence's first token pools to nearly the same vector, so a
# gradient is a small difference of per-sentence terms), so the kernels
# are held to plain bf16 attention's own distance: each leaf's (its worst
# layer's) within BF16_GRAD_RATIO times plain bf16's
BF16_GRAD_RATIO = 1.5

TRAIN_IMAGES, TEST_IMAGES, CLASSES = 512, 128, 10
TRIALS = 2


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def prob_check(label: str, probs: np.ndarray, ref: np.ndarray) -> str:
    """Holds served probabilities against the plain-attention ones
    within ``PROB_RTOL * p + PROB_ATOL``; returns what was measured."""
    err = np.abs(probs - ref)
    used = float((err / (PROB_RTOL * ref + PROB_ATOL)).max())
    rel = float((err / ref).max())
    require(used <= 1, f"{label}: |p - p_plain| up to {err.max():.3g} and "
            f"{rel:.3g} of p: over {PROB_RTOL:g} p + {PROB_ATOL:g} "
            f"({used:.3g} of the bound)")
    return (f"max |p - p_plain| {err.max():.3g}, {rel:.3g} of p at most, "
            f"{used:.3g} of the bound {PROB_RTOL:g} p + {PROB_ATOL:g} "
            f"(max p {ref.max():.3g}, min p {ref.min():.3g})")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls of the CUDA-event time around one call,
    host dispatch included: what a caller waits for one call."""
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


def device_ms(fn, reps: int = 7, inner: int = 20, warmup: int = 3,
              hold_cycles: int = 50_000_000) -> float:
    """Device time of one call: the median over ``reps`` of the CUDA-event
    time around ``inner`` back-to-back calls, divided by ``inner``. The card
    is first held busy (``torch.cuda._sleep``) while the host queues the
    calls, so host dispatch does not show in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)  # 5e7 cycles: ~25 ms
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def print_device_profile(fn, label: str, top: int = 8,
                         shares: tuple = ()) -> None:
    """Device time of one call of ``fn`` by kernel, from torch.profiler
    (CUPTI): the ``top`` kernels and their share of the call's total, then
    the share of each ``(label, name fragment)`` in ``shares``."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not total:
        print(f"profile of one {label}: the profiler saw no device time")
        return
    print(f"profile of one {label}: {total:.3f} ms of kernels in "
          f"{sum(c for _, _, c in rows)} launches (the profile took "
          f"{time.perf_counter() - t0:.1f} s)")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{name[:110]}")
    for what, fragment in shares:
        ms = sum(m for name, m, _ in rows if fragment in name)
        count = sum(c for name, _, c in rows if fragment in name)
        print(f"  {what}: {ms:.3f} ms, {100 * ms / total:.1f}% of the "
              f"{label}, x{count}")


def attention_bound(kind, b, h, sq, skv, dh, causal, dtype):
    """(bound_ms, bound_by, bytes) of one call of an attention kernel: the
    bytes it must move and the larger
    of its bytes over HBM bandwidth (each input read once, each output
    written once) and its FLOPs over the type's peak, both counted from
    the visible (query, key) pairs of this call.

    - fwd: reads q, k, v; writes o; 4 Dh FLOPs a pair (QK^T, PV);
    - fwd_lse: fwd, and writes the (B*H, Sq) f32 LSE and, for bf16, the
      f32 output the backward's delta is taken from; for bf16 6 Dh FLOPs a
      pair (PV is two bf16 products, of P rounded and of its remainder);
    - dq: reads q, k, v, dO, lse and the f32 output; writes dq and delta
      = rowsum(dO o O); 6 Dh FLOPs a pair (QK^T, dO V^T, dS K), for bf16
      8 (dS K as two products), and 2 Dh a row (delta);
    - dkv: reads as dq; writes dk, dv; 8 Dh a pair (K Q^T, V dO^T, P^T dO,
      dS^T Q), for bf16 10 (dS^T Q as two products)."""
    size = torch.tensor([], dtype=dtype).element_size()
    split = 2 if size < 4 else 0  # bf16: the split product's FLOPs a Dh
    q_el, kv_el, rows = b * h * sq * dh, b * h * skv * dh, b * h * sq
    nbytes, per_pair = {
        "fwd": ((2 * q_el + 2 * kv_el) * size, 4),
        "fwd_lse": ((2 * q_el + 2 * kv_el) * size + 4 * rows
                    + (4 * q_el if size < 4 else 0), 4 + split),
        "dq": ((3 * q_el + 2 * kv_el) * size + 4 * q_el + 8 * rows,
               6 + split),
        "dkv": ((2 * q_el + 4 * kv_el) * size + 8 * rows, 8 + split),
    }[kind]
    if causal:
        i = np.arange(sq)[:, None]
        j = np.arange(skv)[None, :]
        pairs = int((j <= i + (skv - sq)).sum())
    else:
        pairs = sq * skv
    flops = per_pair * b * h * pairs * dh + (2 * q_el if kind == "dq" else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def rate(bound, ms) -> str:
    """Achieved device-memory rate and share of the bound of a call that
    took ``ms``."""
    return (f"{bound[2] / ms / 1e9:.2f} TB/s, {100 * bound[0] / ms:.0f}% of "
            f"the bound")


# ---------------------------------------------------------------------------
# phase 1: header and build
# ---------------------------------------------------------------------------

# each kernel's main-path instantiation: bf16, Dh = 64
PTXAS = (("K1", "flash_fwd", "flash_fwd_wgmma_kernelILi64ELb0EE"),
         ("K1-LSE", "flash_fwd", "flash_fwd_wgmma_kernelILi64ELb1EE"),
         ("K2", "flash_bwd", "flash_bwd_dq_wgmma_kernelILi64EE"),
         ("K3", "flash_bwd", "flash_bwd_dkv_wgmma_kernelILi64EE"))


def header() -> str:
    """The card's line, then the kernel build."""
    card = card_line()
    build_kernels()
    return card


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``), printed with the
    versions; returned for every phase's lines."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python "
          f"{sys.version.split()[0]}")
    return card


def build_kernels() -> None:
    """Every kernel library built from the checkout's sources, one
    ``nvcc`` a source, all at once; each kernel's ptxas report."""
    from rafiki_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"kernel build: {json.dumps(seconds)} "
          f"({time.perf_counter() - t0:.1f} s wall, one nvcc per source, "
          f"sm_90a, sources {_build.CSRC.relative_to(REPO)}, "
          f"libraries {_build.BUILD_DIR.relative_to(REPO)})")
    for label, source, symbol in PTXAS:
        log = _build.build_logs.get(source)
        m = re.search(symbol + r".*?\n.*?\n\s*(.*?spill loads)\n.*?(Used .*?)\n",
                      log or "", re.S)
        print(f"ptxas {label} (bf16, Dh=64, {symbol}): "
              + (f"{m.group(2)}; {m.group(1)}" if m else
                 "library was already built (no report)" if log is None
                 else "symbol not found in the build log"))


class _Beside:
    """Phases run on a thread beside the main one (while ``nvcc``
    builds): their results, or their error raised, at :meth:`join`."""

    def __init__(self, fn):
        self._out = {}

        def run():
            try:
                self._out["result"] = fn()
            except BaseException as e:  # raised again at join
                self._out["error"] = e

        self._thread = threading.Thread(target=run, name="beside",
                                        daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["result"]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rel_err(out, ref) -> float:
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))


def _out_err(out, ref, per_element: bool) -> tuple:
    """(error, what it is) of an attention output against its plain
    version: the largest absolute error, or where ``per_element`` the
    largest over max(1, |ref|) element by element (the case of a large
    causal batch: its first rows see a key or two and output values of
    ~|v|, up to ~4.5 at B=8, H=12, where one bf16 ulp is 2^-6), as
    tests/test_torch_cuda.py's large-batch causal test holds them."""
    err = (out.float() - ref.float()).abs()
    if not per_element:
        return float(err.max()), "max_abs_err"
    return (float((err / ref.float().abs().clamp(min=1.0)).max()),
            "max error over max(1, |ref|)")


def _entry(name, source, replaces, err, tol, shape, kernel_ms, plain_ms,
           library_ms, bound, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "dtype": "bf16",
            "max_abs_err": err, "tolerance": tol, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound[0], "bound_by": bound[1], **extra}


def kernel_phase():
    """Every kernel against its plain version; returns the kernels'
    entries for the ``{"kernels": [...]}`` line (launches are filled in
    from the main paths) and K1's serving times by batch."""
    # the module (ops/__init__ re-exports the function under its name)
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def qkv(b, h, sq, skv, dh, dtype):
        return [randn(b, h, s, dh, dtype=dtype) for s in (sq, skv, skv)]

    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k, the
    # output's error per element)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("vit B=8", 8, 12, 196, 196, 64, False, bf16, 64, 64, False),
        ("vit B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64, False),
        # phase 8's shapes: BERT-base serving, the LM's causal evaluate
        ("bert B=64", 64, 12, 128, 128, 64, False, bf16, 64, 64, False),
        ("lm causal B=8", 8, 12, 512, 512, 64, True, bf16, 64, 64, True),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16, False),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64, False),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16,
         False),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32, False),
    ]
    entries, times = {}, {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk, per_el in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        out = fa.flash_attention(q, k, v, causal, None, bq, bk)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal, None, bk)
        err, measure = _out_err(out, ref, per_el)
        tol = TOL[dtype]
        line = (f"K1 {label}: B={b} H={h} Sq={sq} Skv={skv} Dh={dh} "
                f"causal={causal} {str(dtype).split('.')[-1]} "
                f"tiles {bq}x{bk}: {measure} {err:.3g} (tol {tol:g})")
        require(bool(torch.isfinite(out).all()), f"{line}: non-finite")
        require(err <= tol, line)
        if label.startswith("dead rows"):
            dead = sq - skv  # rows i < Sq - Skv see no key
            dead_max = float(out[:, :, :dead].abs().max())
            require(dead_max == 0.0, f"{line}: dead rows not 0 ({dead_max})")
            line += f"; dead rows exactly 0 ({dead} rows)"
        if label.startswith("vit"):
            fn_kernel = lambda: fa.flash_attention(q, k, v, causal, None, bq,
                                                   bk)
            kernel_ms = times[b] = device_ms(fn_kernel)
            plain_ms = device_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal, None, bk))
            library_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
            bound = attention_bound("fwd", b, h, sq, skv, dh, causal, dtype)
            line += (f"; kernel_ms {kernel_ms:.4f} ({rate(bound, kernel_ms)})"
                     f", plain_ms {plain_ms:.4f}, library_ms (SDPA) "
                     f"{library_ms:.4f}, bound_ms {bound[0]:.4f} "
                     f"({bound[1]})")
            entries["flash_fwd"] = _entry(
                "flash_fwd", "rafiki_tpu_torch/ops/csrc/flash_fwd.cu",
                "rafiki_tpu/ops/flash_attention.py:143", err, tol,
                [b, h, sq, dh], kernel_ms, plain_ms, library_ms, bound)
        print(line, flush=True)
    entries["flash_fwd"]["strided_ms"] = strided_serving_case(fa, randn)
    entries.update(training_kernels(fa, qkv, randn))
    backward_head_dims(fa, randn)
    return entries, times


def projection_views(randn, b, h, s, dh, n=3):
    """``n`` bf16 (B, H, S, Dh) views of (B, S, H, Dh) memory, as the
    projection einsum hands q, k, v (and its backward dO) over, unit
    variance."""
    bf16 = torch.bfloat16
    x = randn(b, s, h * dh, dtype=bf16)
    views = [torch.einsum("bsd,dhk->bhsk", x, (randn(
        h * dh, h, dh, dtype=torch.float32) / (h * dh) ** 0.5).to(bf16))
        for _ in range(n)]
    require(not views[0].is_contiguous(),
            f"einsum gave a contiguous view {views[0].stride()}")
    return views


def strided_serving_case(fa, randn) -> float:
    """K1 at B=64 on the serving layout: q, k, v as the projection einsum
    hands them over, (B, H, S, Dh) views of (B, S, H, Dh) memory, which the
    kernel reads through its tensor maps without a copy. Returns its device
    time."""
    bf16 = torch.bfloat16
    b, h, sq, dh = 64, 12, 196, 64
    q, k, v = projection_views(randn, b, h, sq, dh)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v)
    err = float((out.float() - ref.float()).abs().max())
    line = (f"K1 vit B=64, strided views {tuple(q.stride())}: max_abs_err "
            f"{err:.3g} (tol {TOL[bf16]:g})")
    require(bool(torch.isfinite(out).all()), f"{line}: non-finite")
    require(err <= TOL[bf16], line)
    kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v))
    library_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    bound = attention_bound("fwd", b, h, sq, sq, dh, False, bf16)
    print(f"{line}; kernel_ms {kernel_ms:.4f} ({rate(bound, kernel_ms)}), "
          f"plain_ms {plain_ms:.4f}, library_ms (SDPA on the same views) "
          f"{library_ms:.4f}", flush=True)
    return kernel_ms


def training_kernels(fa, qkv, randn, cases=None):
    """K1 with the LSE, K2 and K3 against their plain versions at the
    training shape (timed) and at K1's edge cases, or at ``cases``."""
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k, the
    # output's error per element)
    cases = cases or [
        ("train B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64, False),
        # phase 8's training shapes: BERT-base, and the LM causal
        ("bert B=32", 32, 12, 128, 128, 64, False, bf16, 64, 64, False),
        ("lm causal B=8", 8, 12, 512, 512, 64, True, bf16, 64, 64, True),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16, False),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64, False),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16,
         False),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32, False),
    ]
    entries = {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk, per_el in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        dout = randn(b, h, sq, dh, dtype=dtype)
        out, lse, out32 = fa.flash_attention_lse(q, k, v, causal, None, bq,
                                                 bk)
        torch.cuda.synchronize()
        ref_out, ref_lse, ref_out32 = fa.flash_attention_plain(
            q, k, v, causal, None, bk, return_lse=True)
        # K2 and K3 get the plain forward's out and lse, K3 PyTorch's
        # delta: each kernel alone
        delta = fa._delta(ref_out32, dout)
        args = (q, k, v, dout, ref_lse, delta, causal, None, bq, bk)
        dq, dq_delta = fa.flash_attention_dq(q, k, v, dout, ref_lse,
                                             ref_out32, *args[6:])
        dk, dv = fa.flash_attention_dkv(*args)
        torch.cuda.synchronize()
        ref_dq = fa.flash_attention_dq_plain(*args[:-2], bk)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*args[:-2], bq)
        live = torch.isfinite(ref_lse)
        out_err, measure = _out_err(out, ref_out, per_el)
        errs = {
            "out": max(out_err, _out_err(out32, ref_out32, per_el)[0]),
            "lse": float((lse[live] - ref_lse[live]).abs().max()),
            "dq": float((dq.float() - ref_dq.float()).abs().max()),
            "dk": float((dk.float() - ref_dk.float()).abs().max()),
            "dv": float((dv.float() - ref_dv.float()).abs().max()),
            "delta": _rel_err(dq_delta, delta),
        }
        rel = {"dq": _rel_err(dq, ref_dq), "dk": _rel_err(dk, ref_dk),
               "dv": _rel_err(dv, ref_dv)}
        where = (f"B={b} H={h} Sq={sq} Skv={skv} Dh={dh} causal={causal} "
                 f"{str(dtype).split('.')[-1]} tiles {bq}x{bk}")
        line = (f"K1-LSE/K2/K3 {label}: {where}: out {measure} "
                f"{errs['out']:.3g}, max_abs_err lse {errs['lse']:.3g} (tol "
                f"{LSE_TOL[dtype]:g}), dq {errs['dq']:.3g}, dk "
                f"{errs['dk']:.3g}, dv {errs['dv']:.3g}; relative "
                + ", ".join(f"{n} {e:.3g}" for n, e in rel.items())
                + f" (tol {TOL[dtype]:g}), K2's delta {errs['delta']:.3g} "
                f"(tol {DELTA_TOL:g})")
        require(all(bool(torch.isfinite(t).all())
                    for t in (out, dq, dk, dv, dq_delta)),
                f"{line}: non-finite")
        require(errs["delta"] <= DELTA_TOL, line)
        require(torch.equal(torch.isfinite(lse), live),
                f"{line}: LSE finite on other rows than the plain one")
        require(errs["out"] <= TOL[dtype], line)
        require(errs["lse"] <= LSE_TOL[dtype], line)
        require(all(e <= TOL[dtype] for e in rel.values()), line)
        if label.startswith("dead rows"):
            dead = sq - skv
            dq_dead = float(dq[:, :, :dead].abs().max())
            lse_dead = lse.view(b, h, sq)[:, :, :dead]
            require(dq_dead == 0.0 and bool(torch.isinf(lse_dead).all())
                    and float(out[:, :, :dead].abs().max()) == 0.0,
                    f"{line}: dead rows: dq {dq_dead}, lse not all +inf, "
                    "or out not 0")
            line += (f"; dead rows: out and dq exactly 0, lse +inf "
                     f"({dead} rows)")
        if label.startswith("train"):
            line += "\n" + timed_training_kernels(fa, randn, entries, args,
                                                   ref_out32, errs, rel)
        print(line, flush=True)
    return entries


def backward_head_dims(fa, randn) -> None:
    """K2 and K3 against their plain versions at every head dim: S=196,
    causal with Sq<Skv, and dead rows (contiguous inputs), then on the
    projection's strided views of q, k, v and dO, which must give the same
    bits as contiguous copies. Each kernel gets the plain forward's lse and
    f32 output (K3 PyTorch's delta), so it is held alone; K2's delta is
    checked against PyTorch's."""
    tol = TOL[torch.bfloat16]
    for dh in fa.HEAD_DIMS:
        # (label, b, h, sq, skv, causal)
        cases = [("S=196", 2, 4, 196, 196, False),
                 ("Sq<Skv causal", 2, 4, 64, 196, True),
                 ("dead rows", 2, 4, 196, 64, True),
                 ("views", 2, 4, 196, 196, False)]
        parts = []
        for label, b, h, sq, skv, causal in cases:
            if label == "views":
                q, k, v, dout = projection_views(randn, b, h, sq, dh, n=4)
            else:
                q, k, v, dout = (randn(b, h, s, dh, dtype=torch.bfloat16)
                                 for s in (sq, skv, skv, sq))
            copies = [t.contiguous() for t in (q, k, v, dout)]
            _, lse, out32 = fa.flash_attention_plain(*copies[:3], causal,
                                                     return_lse=True)
            delta = fa._delta(out32, copies[3])
            args = (lse, delta, causal)
            dq, dq_delta = fa.flash_attention_dq(q, k, v, dout, lse, out32,
                                                 causal)
            got = (dq, *fa.flash_attention_dkv(q, k, v, dout, *args))
            torch.cuda.synchronize()
            ref = (fa.flash_attention_dq_plain(*copies, *args),
                   *fa.flash_attention_dkv_plain(*copies, *args))
            rel = max(_rel_err(a, r) for a, r in zip(got, ref))
            delta_err = _rel_err(dq_delta, delta)
            where = (f"K2/K3 Dh={dh} {label} (B={b} H={h} Sq={sq} Skv={skv} "
                     f"causal={causal})")
            require(all(bool(torch.isfinite(t).all())
                        for t in (*got, dq_delta)), f"{where}: non-finite")
            require(rel <= tol, f"{where}: relative error {rel:.3g} > {tol}")
            require(delta_err <= DELTA_TOL,
                    f"{where}: K2's delta off by {delta_err:.3g}")
            part = f"{label} {rel:.3g} (delta {delta_err:.2g})"
            if label == "dead rows":
                dq_dead = float(got[0][:, :, :sq - skv].abs().max())
                require(dq_dead == 0.0, f"{where}: dead rows' dq {dq_dead}")
                part += " (dead rows' dq 0)"
            if label == "views":
                same = (*fa.flash_attention_dq(*copies, lse, out32, causal),
                        *fa.flash_attention_dkv(*copies, *args))
                require(all(torch.equal(a, c) for a, c in zip(
                    (dq, dq_delta, *got[1:]), same)),
                        f"{where}: views and contiguous copies differ")
                part += " (bits of contiguous copies)"
            parts.append(part)
        print(f"K2/K3 at Dh={dh}, max relative error of dq, dk, dv (tol "
              f"{tol:g}): " + ", ".join(parts), flush=True)


def timed_training_kernels(fa, randn, entries, args, out32, errs,
                           rel) -> str:
    """Device times of K1 with the LSE, K2 and K3 at the training shape,
    beside their plain versions, their bounds and PyTorch's SDPA: its
    forward with inputs that require grad (it then keeps the LSE too) for
    K1, its backward for K2 and K3 together; and K2, K3 on the
    projection's strided views, as the train step hands them over. K2
    takes delta from the f32 output (``out32``); its plain version
    includes PyTorch's delta, which is also timed alone."""
    q, k, v, dout, lse, delta, causal, _, bq, bk = args
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    shape = [b, h, sq, dh]
    t = {
        "fwd_lse": device_ms(
            lambda: fa.flash_attention_lse(q, k, v, causal, None, bq, bk)),
        "fwd_lse_plain": device_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal, None, bk,
                                             return_lse=True), reps=3),
        "dq": device_ms(lambda: fa.flash_attention_dq(
            q, k, v, dout, lse, out32, causal, None, bq, bk)),
        "dq_plain": device_ms(lambda: fa.flash_attention_dq_plain(
            q, k, v, dout, lse, fa._delta(out32, dout), causal, None, bk),
            reps=3),
        "delta_torch": device_ms(lambda: fa._delta(out32, dout)),
        "dkv": device_ms(lambda: fa.flash_attention_dkv(*args)),
        "dkv_plain": device_ms(
            lambda: fa.flash_attention_dkv_plain(*args[:-2], bq), reps=3),
    }
    views = projection_views(randn, *q.shape, n=4)
    _, view_lse, view_out32 = fa.flash_attention_lse(*views[:3], causal)
    view_args = (*views, view_lse, fa._delta(view_out32, views[3]), causal)
    t["dq_views"] = device_ms(lambda: fa.flash_attention_dq(
        *views, view_lse, view_out32, causal))
    t["dkv_views"] = device_ms(lambda: fa.flash_attention_dkv(*view_args))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t["sdpa_fwd"] = device_ms(lambda: sdpa(qg, kg, vg, is_causal=causal))
    sdpa_out = sdpa(qg, kg, vg, is_causal=causal)
    t["sdpa_bwd"] = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True))
    bounds = {kind: attention_bound(kind, b, h, sq, skv, dh, causal,
                                    q.dtype)
              for kind in ("fwd_lse", "dq", "dkv")}
    fwd, bwd = "rafiki_tpu_torch/ops/csrc/flash_fwd.cu", \
        "rafiki_tpu_torch/ops/csrc/flash_bwd.cu"
    entries["flash_fwd_lse"] = _entry(
        "flash_fwd_lse", fwd, "rafiki_tpu/ops/flash_attention.py:143",
        errs["out"], TOL[q.dtype], shape, t["fwd_lse"], t["fwd_lse_plain"],
        t["sdpa_fwd"], bounds["fwd_lse"], lse_max_abs_err=errs["lse"],
        library="scaled_dot_product_attention forward, inputs requiring "
                "grad")
    # the gradients' tolerance is on max|err| / max(1, max|ref|)
    entries["flash_bwd_dq"] = _entry(
        "flash_bwd_dq", bwd, "rafiki_tpu/ops/flash_attention.py:207",
        errs["dq"], TOL[q.dtype], shape, t["dq"], t["dq_plain"],
        t["sdpa_bwd"], bounds["dq"], max_rel_err=rel["dq"],
        tolerance_on="max_rel_err", strided_ms=t["dq_views"],
        delta_max_rel_err=errs["delta"], pytorch_delta_ms=t["delta_torch"],
        library="scaled_dot_product_attention backward (dq, dk and dv "
                "together)")
    entries["flash_bwd_dkv"] = _entry(
        "flash_bwd_dkv", bwd, "rafiki_tpu/ops/flash_attention.py:239",
        max(errs["dk"], errs["dv"]), TOL[q.dtype], shape, t["dkv"],
        t["dkv_plain"], t["sdpa_bwd"], bounds["dkv"],
        max_rel_err=max(rel["dk"], rel["dv"]), tolerance_on="max_rel_err",
        strided_ms=t["dkv_views"],
        library="scaled_dot_product_attention backward (dq, dk and dv "
                "together)")
    return "\n".join(
        f"  {name}: kernel_ms {t[key]:.4f} ({rate(bounds[key], t[key])}), "
        f"plain_ms {t[key + '_plain']:.4f}, bound_ms {bounds[key][0]:.4f} "
        f"({bounds[key][1]})"
        for name, key in (("K1-LSE", "fwd_lse"), ("K2", "dq"),
                          ("K3", "dkv"))) + (
        f"\n  PyTorch's delta alone (which K2 takes itself): "
        f"{t['delta_torch']:.4f} ms"
        f"\n  on the projection's strided views: K2 {t['dq_views']:.4f} ms, "
        f"K3 {t['dkv_views']:.4f} ms"
        f"\n  library: SDPA forward (grad) {t['sdpa_fwd']:.4f} ms, SDPA "
        f"backward {t['sdpa_bwd']:.4f} ms; K2 + K3 {t['dq'] + t['dkv']:.4f}"
        f" ms")


# ---------------------------------------------------------------------------
# phase 3: the train job
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
# their wrappers' launch counters, in the same order
COUNTERS = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
            "flash_attention_dkv")


def _kernels():
    """The four kernel wrappers, in KERNEL_NAMES order."""
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    return (fa.flash_attention, fa.flash_attention_lse,
            fa.flash_attention_dq, fa.flash_attention_dkv)


def make_dataset(rng: np.random.Generator, n: int, patterns: np.ndarray):
    """``n`` images of 224x224x3 in [0, 1] at 8-bit levels, as decoded
    image files are, each its class's fixed pattern plus noise: a signal
    that can be learnt."""
    y = rng.integers(0, len(patterns), n).astype(np.int32)
    x = 0.6 * patterns[y] + 0.4 * rng.random(
        (n,) + patterns.shape[1:], dtype=np.float32)
    return np.round(x * 255) / np.float32(255), y


def write_train_dataset() -> dict:
    """The seeded synthetic ViT dataset of phases 3-6 and 9, written as
    ``.npz`` under ``WORK`` (uncompressed: ``savez_compressed`` took ~40 s
    of the script for 60% of the bytes); its URIs by split."""
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    patterns = rng.random((CLASSES, 224, 224, 3), dtype=np.float32)
    uris = {}
    for split, n in (("train", TRAIN_IMAGES), ("test", TEST_IMAGES)):
        x, y = make_dataset(rng, n, patterns)
        uris[split] = str(WORK / f"{split}.npz")
        np.savez(uris[split], x=x, y=y)
    print(f"train: dataset of {TRAIN_IMAGES} + {TEST_IMAGES} images "
          f"(224x224x3, {CLASSES} classes) made and written as .npz in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(Path(u).stat().st_size for u in uris.values()) / 1e6:.0f}"
          f" MB)", flush=True)
    return uris


def train_phase(card: str):
    """A 2-trial ViT-B/16 train job through ``TrainWorker`` on cuda:0.
    Returns (the store, the dataset's URIs, trial rows, the job's seconds,
    each kernel's launches in ``KERNEL_NAMES`` order)."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.constants import TrialStatus
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.log import LogType
    from rafiki_tpu_torch.sdk.params import flatten, load_params

    uris = write_train_dataset()

    # ---- the main path's run: counts from zero (inside) ----
    db, trials, job_s, counts = direct_train_job(uris, WORK / "params")
    # ---------------------------------------------------------------

    require(len(trials) == TRIALS, f"{len(trials)} trials, not {TRIALS}")
    cfg = vit.vit_b16()
    init = flatten(vit.init(np.random.default_rng(0), cfg))
    steps = 0
    for t in trials:
        require(t["status"] == TrialStatus.COMPLETED,
                f"trial {t['id']} {t['status']}: {t['fault_detail']}")
        require(np.isfinite(t["score"]), f"trial score {t['score']}")
        records = [json.loads(line) for line in db.get_trial_logs(t["id"])]
        epochs = [r["metrics"] for r in records
                  if r["type"] == LogType.METRICS and "loss" in r["metrics"]]
        require(epochs and all(np.isfinite(m["loss"]) for m in epochs),
                f"trial {t['id']} losses {epochs}")
        trained = flatten(load_params(read_artifact(t["params_file_path"])))
        still = [k for k in init if np.array_equal(init[k], trained[k])]
        require(not still, f"trial {t['id']}: {still} did not move")
        moved = max(float(np.abs(trained[k] - init[k]).max()) for k in init)
        batch = t["knobs"]["batch_size"]
        steps += (TRAIN_IMAGES // batch) * t["knobs"]["epochs"]
        print(f"train: trial {t['id'][:8]} COMPLETED: learning_rate "
              f"{t['knobs']['learning_rate']:.3g}, batch_size {batch}, "
              f"epoch loss {epochs[-1]['loss']:.4f} in "
              f"{epochs[-1]['epoch_time']:.2f} s, test accuracy "
              f"{t['score']:.4f}; every one of {len(init)} parameter "
              f"arrays moved (max |change| {moved:.3g})", flush=True)
    expect = [DEPTH * TRIALS, DEPTH * steps, DEPTH * steps, DEPTH * steps]
    print(f"train: job of {TRIALS} trials in {job_s:.1f} s; {steps} train "
          f"steps, {TRIALS} evaluate forwards; launches K1 {counts[0]}, "
          f"K1-LSE {counts[1]}, K2 {counts[2]}, K3 {counts[3]} (expected "
          f"{expect})", flush=True)
    require(counts == expect, f"launches {counts}, expected {expect}")
    train_step_checks(card, cfg, convert, uris["train"])
    return db, uris, trials, job_s, counts


def direct_train_job(uris: dict, params_dir: Path):
    """A ``TRIALS``-trial ViT-B/16 train job through ``TrainWorker`` on
    cuda:0, its rows in an in-memory ``Database``. Returns (the store, the
    trial rows, the job's seconds, each kernel's launches in the job, in
    ``KERNEL_NAMES`` order); the counts start from zero here."""
    from rafiki_tpu_torch.advisor.advisor import AdvisorStore
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.worker.train import TrainWorker

    db, advisors = Database(":memory:"), AdvisorStore()
    user = db.create_user("smoke@rafiki", "-", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                            no_checkpoint(TEMPLATE.read_bytes()), "TorchViT",
                            {}, "PRIVATE")
    job = db.create_train_job(user["id"], "vit", 1, "IMAGE_CLASSIFICATION",
                              uris["train"], uris["test"],
                              {"MODEL_TRIAL_COUNT": TRIALS})
    sub = db.create_sub_train_job(job["id"], model["id"])
    ctx = ServiceContext("train-worker-0", chips=[0])
    worker = TrainWorker(sub["id"], db, advisors, params_dir=str(params_dir))
    kernels = _kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    worker.start(ctx)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    return (db, db.get_trials_of_sub_train_job(sub["id"]), job_s,
            [kernel.launches for kernel in kernels])


def _step_grads(cfg, tree: dict, loss_of, dtype) -> tuple:
    """(loss, {name: gradient in f64}) of one step from ``tree`` (built by
    ``convert.from_jax_params`` on cuda:0 under ``cfg``) computing in
    ``dtype``: ``loss_of(model, dtype)``."""
    from rafiki_tpu_torch import convert

    model = convert.from_jax_params(tree, cfg, "cuda:0", train=True)
    loss = loss_of(model, dtype)
    loss.backward()
    return float(loss.detach()), {k: p.grad.double() for k, p in
                                  model.named_parameters()}


def _rel_l2(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def _worst_by_leaf(errs: dict) -> dict:
    """The worst layer's error of each leaf."""
    by_leaf = {}
    for k, e in errs.items():
        leaf = re.sub(r"^blocks\.\d+\.", "blocks.*.", k)
        by_leaf[leaf] = max(by_leaf.get(leaf, 0.0), e)
    return by_leaf


def _leaves(errs: dict) -> str:
    return ", ".join(f"{k} {e:.2e}" for k, e in
                     sorted(_worst_by_leaf(errs).items()))


def _plain(cfg):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))


def step_vs_plain(label: str, cfg, tree: dict, loss_of,
                  dtype=torch.bfloat16, plain=None) -> None:
    """One train step's loss and gradients through the kernels against
    those through plain attention, from the same weights and batch
    (``loss_of(model, dtype)``), computing in ``dtype``: the loss within
    LOSS_ATOL, each parameter's gradient within GRAD_RTOL of its L2 norm
    (the q/k projections' within QK_GRAD_RTOL). ``plain``: the plain
    step's (loss, gradients), where already taken."""
    loss_k, g_k = _step_grads(cfg, tree, loss_of, dtype)
    loss_p, g_p = plain or _step_grads(_plain(cfg), tree, loss_of, dtype)
    rel = _rel_l2(g_k, g_p)
    print(f"{label}, kernels vs plain attention ({str(dtype)[6:]}): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3g}, "
          f"tol {LOSS_ATOL:g}); gradient relative L2 error per leaf (worst "
          f"layer; tol {GRAD_RTOL:g}, {QK_GRAD_RTOL:g} for "
          f"{'/'.join(QK_LEAVES)}): {_leaves(rel)}", flush=True)
    require(abs(loss_k - loss_p) <= LOSS_ATOL, f"{label}: loss differs")
    for k, e in rel.items():
        tol = QK_GRAD_RTOL if k.endswith(QK_LEAVES) else GRAD_RTOL
        require(e <= tol, f"{label}: gradient of {k} off by {e:.3g} (tol "
                f"{tol:g})")


def text_step_gates(label: str, cfg, tree: dict, loss_of) -> None:
    """One train step from ``tree`` four ways, f32 and bf16, each through
    the kernels and through plain attention. The f32 kernels are held to
    the f32 plain step by :func:`step_vs_plain`. The bf16 kernels, which
    the main path runs, are held to the f32 plain step against plain bf16
    attention: their loss within LOSS_ATOL of plain bf16's, and each
    leaf's gradient (its worst layer) within BF16_GRAD_RATIO times plain
    bf16's distance from f32."""
    f32 = _step_grads(_plain(cfg), tree, loss_of, torch.float32)
    step_vs_plain(label, cfg, tree, loss_of, torch.float32, plain=f32)
    loss_k, g_k = _step_grads(cfg, tree, loss_of, torch.bfloat16)
    loss_p, g_p = _step_grads(_plain(cfg), tree, loss_of, torch.bfloat16)
    worst_k, worst_p = (_worst_by_leaf(_rel_l2(g, f32[1]))
                        for g in (g_k, g_p))
    ratio = {k: worst_k[k] / max(worst_p[k], 1e-30) for k in worst_k}
    direct = _worst_by_leaf(_rel_l2(g_k, g_p))
    far = max(direct, key=direct.get)
    print(f"{label}, bf16 against f32 plain attention: loss through the "
          f"kernels {loss_k:.6f}, plain {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3g}, tol {LOSS_ATOL:g}); gradient "
          f"relative L2 error per leaf (worst layer), the kernels / plain "
          f"bf16 (ratio; tol {BF16_GRAD_RATIO:g}): " + ", ".join(
              f"{k} {worst_k[k]:.2e}/{worst_p[k]:.2e} ({ratio[k]:.2f})"
              for k in sorted(worst_k)) + "; the kernels against plain "
          f"bf16 directly, worst leaf: {far} {direct[far]:.2e}", flush=True)
    require(abs(loss_k - loss_p) <= LOSS_ATOL, f"{label}: bf16 loss differs")
    for k, r in ratio.items():
        require(r <= BF16_GRAD_RATIO, f"{label}: bf16 gradient of {k} "
                f"{worst_k[k]:.3g} from f32, {r:.3g} times plain bf16's "
                f"{worst_p[k]:.3g} (tol {BF16_GRAD_RATIO:g})")


def train_step_checks(card, cfg, convert, train_uri):
    """One train step through the kernels against one through plain
    attention, from the same weights and batch; then the step's time and a
    kernel profile."""
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.dataset import dataset_utils
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    x, y = dataset_utils.load_image_arrays(train_uri)
    tree = vit.init(np.random.default_rng(0), cfg)
    loss_fn = softmax_classifier_loss(lambda m, xb: m(xb))
    batch = (torch.from_numpy(x[:64]).cuda(), torch.from_numpy(y[:64]).cuda())
    step_vs_plain("train: one step at batch 64", cfg, tree,
                  lambda model, dtype: loss_fn(model, batch)[0])

    trainer = DataParallelTrainer(
        loss_fn, tunable_optimizer(torch.optim.AdamW, lr=1e-4,
                                   weight_decay=1e-4))
    model, opt = trainer.init(lambda rng: convert.from_jax_params(
        tree, cfg, "cuda:0", train=True))
    for n in (64, 128):
        batch = (torch.from_numpy(x[:n]).cuda(),
                 torch.from_numpy(y[:n]).cuda())
        step = lambda: trainer.train_step(model, opt, batch)  # noqa: E731
        call_ms = median_ms(step, reps=10)
        card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
        print(f"train: step at batch {n}: {call_ms:.2f} ms per call, "
              f"{card_ms:.2f} ms on the card; {n / call_ms * 1e3:.1f} "
              f"images/s per call ({n / card_ms * 1e3:.1f} on the card); "
              f"card {card}", flush=True)
        if n == 64:
            print_device_profile(step, "batch-64 train step", shares=(
                ("K1-LSE", "flash_fwd_wgmma_kernel"),
                ("K2", "flash_bwd_dq_wgmma_kernel"),
                ("K3", "flash_bwd_dkv_wgmma_kernel"),
                ("copies and casts", "copy_kernel")))
    del model, opt


# ---------------------------------------------------------------------------
# phase 4: serving the trained trials
# ---------------------------------------------------------------------------

NPY = "application/x-npy"


def request_body(kind: str, images: np.ndarray):
    """(body, headers) of a ``POST /predict`` carrying ``images``: an
    ``.npy`` body asking for an ``.npy`` answer, or a JSON body."""
    if kind == "npy":
        buf = io.BytesIO()
        np.save(buf, images, allow_pickle=False)
        return buf.getvalue(), {"Content-Type": NPY, "Accept": NPY}
    return (json.dumps({"queries": images.tolist()}).encode(),
            {"Content-Type": "application/json"})


def post(url: str, body: bytes, headers: dict,
         token: str = None) -> np.ndarray:
    if token is not None:
        headers = {**headers, "Authorization": f"Bearer {token}"}
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as resp:
        require(resp.status == 200, f"POST /predict answered {resp.status}")
        data = resp.read()
        if resp.headers["Content-Type"] == NPY:
            return np.load(io.BytesIO(data), allow_pickle=False)
        return np.asarray(json.loads(data)["data"]["predictions"])


#: phase 5's admin-door p50 (ms) by request size, beside phase 19's
STACK_P50: dict = {}
#: the JSON requests both doors are timed on in turns (phase 5)
#: JSON requests of 1 and of 8 images timed on each door (phases 5-6):
#: three a size (ten, then five before; cut for the run's time limit)
JSON_TIMED = [("json", 1)] * 3 + [("json", 8)] * 3


def p50_ms(lat: dict) -> dict:
    """{(kind, n): median ms} of {(kind, n): [seconds]}."""
    return {k: statistics.median(v) * 1e3 for k, v in lat.items()}


def serve_phase(card: str, kernel_ms: dict, db, trials):
    """The trained trials behind ``POST /predict``; returns each kernel's
    launches on the main path, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.cache.queue import InProcessBroker
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.ops.flash_attention import flash_attention
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    cfg = vit.vit_b16()
    trees = {t["id"]: load_params(read_artifact(t["params_file_path"]))
             for t in trials}
    print(f"serve: the {len(trees)} trained ViT-B/16 trials (224/16, 1000 "
          f"classes, {_count(next(iter(trees.values()))) / 1e6:.1f} M "
          f"params each), scores "
          f"{[round(t['score'], 4) for t in trials]}", flush=True)

    broker = InProcessBroker()
    job = "vit-b16-job"
    workers = {}
    launches_before_warm = flash_attention.launches
    t0 = time.perf_counter()
    for i, tid in enumerate(trees):
        ready, errors = threading.Event(), []
        ctx = ServiceContext(service_id=f"worker-{i}", chips=[0],
                             on_ready=ready.set)

        def run(w=InferenceWorker(job, tid, db, broker), c=ctx, e=errors):
            try:
                w.start(c)
            except BaseException as exc:  # reported by the main thread
                e.append(exc)
                raise

        thread = threading.Thread(target=run, name=ctx.service_id,
                                  daemon=True)
        thread.start()
        workers[ctx.service_id] = (tid, ctx, thread, ready, errors)
    predictor = Predictor(job, broker, "IMAGE_CLASSIFICATION",
                          {wid: w[0] for wid, w in workers.items()})
    server = None
    try:
        for wid, (_, _, thread, ready, errors) in workers.items():
            while not ready.wait(0.5):
                require(thread.is_alive(), f"{wid} died before ready: "
                        f"{errors[0] if errors else 'unknown'}")
                require(time.perf_counter() - t0 < 600,
                        f"{wid} not ready after 600 s")
        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        warm_launches = flash_attention.launches - launches_before_warm
        print(f"serve: 2 workers ready in {time.perf_counter() - t0:.1f} s; "
              f"warm-up ran buckets {buckets} per worker "
              f"({warm_launches} K1 launches)", flush=True)
        require(warm_launches == DEPTH * len(buckets) * len(workers),
                f"warm-up made {warm_launches} K1 launches")
        server = PredictorServer(predictor, app="vit", auth=False).start()
        url = f"http://127.0.0.1:{server.port}/predict"

        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((cap, 224, 224, 3)).astype(np.float32)
        checked = [("json", 1), ("npy", 3), ("npy", 8), ("npy", cap)]
        timed = [("npy", 1)] * 8 + [("npy", cap)] * 8

        # request bodies are encoded before the clock starts: that is the
        # client's work, not the server's
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in checked + timed}

        # ---- the main path's run: counts from zero ----
        kernels = _kernels()
        for kernel in kernels:
            kernel.launches = 0
        answers, lat = [], {}
        for kind, n in checked + timed:
            t = time.perf_counter()
            probs = post(url, *bodies[kind, n])
            dt = time.perf_counter() - t
            if len(answers) < len(checked):
                answers.append((kind, n, probs, dt))
            else:
                lat.setdefault((kind, n), []).append(dt)
        launches = [kernel.launches for kernel in kernels]
        # ---------------------------------------------------------------
        chunks = sum(-(-n // cap) for _, n in checked + timed)
        forwards = chunks * len(workers)
        expect = [DEPTH * forwards, 0, 0, 0]
        print(f"serve: {len(checked) + len(timed)} POST /predict requests, "
              f"{forwards} bucketed forwards; launches K1 {launches[0]}, "
              f"K1-LSE {launches[1]}, K2 {launches[2]}, K3 {launches[3]} "
              f"(expected {expect})", flush=True)
        require(launches == expect,
                f"serving launches {launches}, expected {expect}")

        # reference: the two models' forward through plain attention
        plain_cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
        refs = []
        with torch.inference_mode():
            x = torch.from_numpy(images).cuda()
            for tree in trees.values():
                model = convert.from_jax_params(tree, plain_cfg, "cuda:0")
                refs.append(torch.softmax(model(x), -1).double().cpu().numpy())
                del model
        ref = (refs[0] + refs[1]) / 2
        for kind, n, probs, dt in answers:
            require(probs.shape == (n, cfg.num_classes),
                    f"{kind} {n}: shape {probs.shape}")
            require(bool(np.isfinite(probs).all()), f"{kind} {n}: non-finite")
            sums = np.abs(probs.sum(-1) - 1).max()
            require(sums < 1e-4, f"{kind} {n}: rows sum off by {sums}")
            held = prob_check(f"{kind} {n}", probs, ref[:n])
            print(f"serve: {kind} request of {n}: shape {probs.shape}, rows "
                  f"sum to 1 within {sums:.2g}, {held}, {dt * 1e3:.1f} ms",
                  flush=True)
        p50 = p50_ms(lat)
        big = lat["npy", cap]
        print(f"serve: p50 latency {p50['npy', 1]:.2f} ms (1 image), "
              f"{p50['npy', cap]:.2f} ms ({cap} images, npy); "
              f"{cap * len(big) / sum(big):.1f} images/s at "
              f"{cap} per request, sequential; two trials ensembled; card "
              f"{card}", flush=True)

        # where a request's time goes: one trial's forward through the
        # served (kernel) path at each timed bucket; these launches come
        # after the main path's count was read
        model = convert.from_jax_params(next(iter(trees.values())), cfg,
                                        "cuda:0")
        with torch.inference_mode():
            for n, bucket in ((1, 8), (cap, cap)):
                x = torch.from_numpy(images[:bucket]).cuda()
                call_ms = median_ms(lambda: model(x), reps=10)
                card_ms = device_ms(lambda: model(x), reps=3, inner=3,
                                    hold_cycles=400_000_000)
                attn_ms = DEPTH * kernel_ms.get(bucket, float("nan"))
                print(f"serve: {n}-image request (bucket {bucket}): p50 "
                      f"{p50['npy', n]:.2f} ms; one trial's forward "
                      f"{call_ms:.3f} ms per call, {card_ms:.3f} ms of it "
                      f"on the card, of which K1 {attn_ms:.3f} ms ({DEPTH} "
                      f"x kernel_ms); the request less 2 forwards "
                      f"{p50['npy', n] - 2 * call_ms:.2f} ms (host and "
                      f"transport)", flush=True)
            shares = (("K1", "flash_fwd_wgmma_kernel"),
                      ("copies and casts", "copy_kernel"))
            print_device_profile(lambda: model(x), f"bucket-{cap} forward",
                                 shares=shares)
            copied_ms = forward_with_copies(model, x, cap, shares)
            print(f"serve: bucket-{cap} forward on the card: {card_ms:.3f} ms "
                  f"with K1 reading the projection's views, {copied_ms:.3f} "
                  f"ms with q, k, v made contiguous before K1 (as before "
                  f"it read views); card {card}", flush=True)
        del model
        return launches
    finally:
        if server is not None:
            server.stop()
        for wid, (_, ctx, thread, _, _) in workers.items():
            ctx.stop_event.set()
            broker.unregister_worker(job, wid)
        for wid, (_, _, thread, _, _) in workers.items():
            thread.join(timeout=30)
            require(not thread.is_alive(), f"{wid} did not stop")


def forward_with_copies(model, x, cap, shares) -> float:
    """The bucket forward's device time and profile with q, k, v copied to
    contiguous tensors before K1, the serving path before K1 read views:
    the same model and input, one call apart."""
    attention = importlib.import_module("rafiki_tpu_torch.ops.attention")
    real = attention.flash_attention

    def copied(q, k, v, **kw):
        return real(q.contiguous(), k.contiguous(), v.contiguous(), **kw)

    attention.flash_attention = copied
    try:
        ms = device_ms(lambda: model(x), reps=3, inner=3,
                       hold_cycles=400_000_000)
        print_device_profile(lambda: model(x), f"bucket-{cap} forward, q/k/v "
                             "copied before K1", shares=shares)
    finally:
        attention.flash_attention = real
    return ms


# ---------------------------------------------------------------------------
# phase 5: the cycle through Client -> AdminServer -> Admin
# ---------------------------------------------------------------------------

def stack_phase(card: str, uris: dict, direct_job_s: float):
    """A 2-trial train job and an inference job of its trials through the
    port's Client and admin; returns each kernel's launches on this path
    (the train job's and the inference job's together)."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer

    store = WORK / "stack.sqlite3"
    for path in WORK.glob("stack.sqlite3*"):
        path.unlink()
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "stack_params"))
    server = AdminServer(admin).start()
    direct = None
    kernels = _kernels()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                               no_checkpoint(TEMPLATE.read_bytes()),
                               "TorchViT")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchViT upload not verified: {model['verification']}")
        print(f"stack: admin on 127.0.0.1:{server.port} (store {store.name}),"
              f" TorchViT uploaded and verified "
              f"({os.environ.get('RAFIKI_VERIFY_TEMPLATES', 'enforce')}), "
              f"{len(model['verification']['findings'])} findings",
              flush=True)

        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": TRIALS,
                                                 "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        grants = [w["chips"] for w in job["workers"]]
        require(grants == [[0]], f"train services granted {grants}")
        trials = c.get_trials_of_train_job("vit")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        steps = 0
        for t in trials:
            require(np.isfinite(t["score"]), f"trial score {t['score']}")
            epochs = [m for m in c.get_trial_logs(t["id"])["metrics"]
                      if "epoch_time" in m]
            batch = t["knobs"]["batch_size"]
            steps += (TRAIN_IMAGES // batch) * t["knobs"]["epochs"]
            wall = t["datetime_stopped"] - t["datetime_started"]
            fit = sum(m["epoch_time"] for m in epochs)
            print(f"stack: trial {t['id'][:8]} COMPLETED: batch_size {batch},"
                  f" test accuracy {t['score']:.4f}; {wall:.2f} s in the "
                  f"trial, {fit:.2f} s of it in epochs, set-up and the rest "
                  f"{wall - fit:.2f} s", flush=True)
        expect = [DEPTH * TRIALS] + [DEPTH * steps] * 3
        print(f"stack: train job of {TRIALS} trials STOPPED in {job_s:.1f} s "
              f"through the admin (Client.create_train_job to STOPPED), "
              f"{direct_job_s:.1f} s for phase 3's direct job (TrainWorker "
              f"alone, the first job of the process), granted {grants}; "
              f"{steps} steps; launches K1 "
              f"{train_counts[0]}, K1-LSE {train_counts[1]}, K2 "
              f"{train_counts[2]}, K3 {train_counts[3]} (expected {expect}); "
              f"card {card}", flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")

        t0 = time.perf_counter()
        raw = admin.get_trial_params(trials[0]["id"])
        read_s = time.perf_counter() - t0
        # one trial through the client (the other trials read here: the
        # reference below needs every trial's parameters)
        t0 = time.perf_counter()
        data = c.download_trial_params(trials[0]["id"])
        dl_s = time.perf_counter() - t0
        trees = [load_params(data)] + [
            load_params(admin.get_trial_params(t["id"])) for t in trials[1:]]
        print(f"stack: Client.download_trial_params of one trial: "
              f"{len(data) / 1e6:.1f} MB of artifact in {dl_s:.2f} s "
              f"({len(data) / 1e6 / dl_s:.0f} MB/s; base64 inside JSON on "
              f"the wire, {len(data) * 4 / 3 / 1e6:.1f} MB); the verified "
              f"read of the {len(raw) / 1e6:.1f} MB artifact "
              f"(Admin.get_trial_params) takes {read_s:.2f} s of it",
              flush=True)
        del raw, data

        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in JSON_TIMED}
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]

        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("vit")
        deploy_s = time.perf_counter() - t0
        warm = kernels[0].launches
        answers = [(n, np.asarray(c.predict("vit", images[:n].tolist())))
                   for n in (1, 8)]
        # the admin door and a PredictorServer on the job's own Predictor
        # (phase 4's direct door) take each body in turns, the first door
        # alternating, so both see the same process, job and card
        predictor = admin.services.get_predictor(inf["id"])
        require(predictor is not None, "no Predictor for the inference job")
        direct = PredictorServer(predictor, app="vit", auth=False).start()
        doors = {"admin": (f"http://127.0.0.1:{server.port}/predict/vit",
                           token),
                 "direct": (f"http://127.0.0.1:{direct.port}/predict", None)}
        lat = {door: {} for door in doors}
        for i, (kind, n) in enumerate(JSON_TIMED):
            for door in sorted(doors, reverse=bool(i % 2)):
                url, auth = doors[door]
                t = time.perf_counter()
                post(url, *bodies[kind, n], token=auth)
                lat[door].setdefault((kind, n), []).append(
                    time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("vit")
        c.stop_inference_job("vit")
        workers = inf["workers"]
        require(inf["status"] == "RUNNING" and len(workers) == TRIALS,
                f"inference job {inf['status']} with {len(workers)} workers")
        require([w["chips"] for w in workers] == [[0]] * TRIALS,
                f"serving grants {[w['chips'] for w in workers]}")
        forwards = TRIALS * (len(buckets) + 2
                             + len(doors) * len(JSON_TIMED))
        print(f"stack: inference job RUNNING in {deploy_s:.1f} s "
              f"(deploy and warm-up of {TRIALS} workers, grants "
              f"{[w['chips'] for w in workers]}); {warm} K1 launches in "
              f"warm-up; {serve_counts[0]} K1 launches for {forwards} "
              f"bucketed forwards (expected {DEPTH * forwards}); serving "
              f"stats: {stats['batches']} batches, {stats['queries']} "
              f"queries", flush=True)
        require(serve_counts == [DEPTH * forwards, 0, 0, 0],
                f"serving launches {serve_counts}")

        cfg = vit.vit_b16()
        plain_cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
        refs = []
        with torch.inference_mode():
            x = torch.from_numpy(images).cuda()
            for tree in trees:
                m = convert.from_jax_params(tree, plain_cfg, "cuda:0")
                refs.append(torch.softmax(m(x), -1).double().cpu().numpy())
                del m
        ref = sum(refs) / len(refs)
        for n, probs in answers:
            require(probs.shape == (n, cfg.num_classes),
                    f"/predict/vit {n}: shape {probs.shape}")
            require(bool(np.isfinite(probs).all()),
                    f"/predict/vit {n}: non-finite")
            held = prob_check(f"/predict/vit {n}", probs, ref[:n])
            print(f"stack: Client.predict of {n} (JSON) on /predict/vit: "
                  f"shape {probs.shape}, {held}; against the plain-attention "
                  f"ensemble of the downloaded trials", flush=True)
        p50 = {door: p50_ms(v) for door, v in lat.items()}
        STACK_P50.update({n: p50["admin"]["json", n] for n in (1, 8)})
        print("stack: p50 of the same JSON bodies in turns, /predict/vit on "
              "the admin door vs POST /predict on a PredictorServer over "
              "the job's Predictor: "
              + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                          f"{p50['admin']['json', n]:.2f} vs "
                          f"{p50['direct']['json', n]:.2f} ms"
                          for n in (1, 8))
              + f" ({len(JSON_TIMED) // 2} requests each a door, "
              f"sequential); card {card}", flush=True)
    finally:
        if direct is not None:
            direct.stop()
        server.stop()
        admin.shutdown()
    return [a + b for a, b in zip(train_counts, serve_counts)], job_s


# ---------------------------------------------------------------------------
# phase 6: process placement
# ---------------------------------------------------------------------------

IMAGE_BYTES_JSON = 224 * 224 * 3 * 8  # a JSON image crosses the ring as f64
RING_SEGMENTS = 3  # a query ring per serving child, one response ring


def choose_ring() -> tuple:
    """(ring bytes, the request sizes whose frame fits it): the largest of
    16, 8, 4, 2 MiB whose segments take at most 80% of /dev/shm's free
    space, after printing ``df -B1 /dev/shm``."""
    import shutil

    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                        text=True, check=True).stdout.strip()
    print("process: df -B1 /dev/shm:\n  " + df.replace("\n", "\n  "),
          flush=True)
    free = shutil.disk_usage("/dev/shm").free
    ring = next((mib << 20 for mib in (16, 8, 4, 2)
                 if RING_SEGMENTS * (mib << 20) <= 0.8 * free), 0)
    sizes = [n for n in (1, 8) if n * IMAGE_BYTES_JSON + 4096 <= ring]
    require(1 in sizes, f"/dev/shm has {free} bytes free: no ring of 2 MiB "
            f"or more fits {RING_SEGMENTS} segments")
    return ring, sizes


def child_records(logs: Path, kind: str) -> dict:
    """{service id: [JSON of each ``kind`` line]} from the children's logs
    (a restarted child appends a line)."""
    out = {}
    for path in logs.glob("service-*.log"):
        out[path.stem[len("service-"):]] = [
            json.loads(m.group(2)) | {"pid": int(m.group(1))}
            for m in re.finditer(kind + r" \(pid (\d+)\): (\{.*\})",
                                 path.read_text())]
    return out


def train_timeline(c, trials: list, t0: float, job_s: float,
                   started: dict) -> None:
    """Where the process-placed train job's wall time went, on the wall
    clock (the child's stamps and the trial rows are ``time.time()``):
    create to the child's start, the child's start-up, then each trial's
    set-up and epochs, and the tail to STOPPED."""
    trials = sorted(trials, key=lambda t: t["datetime_started"])
    parts = [("create to child start", started["t_start"] - t0),
             ("child start to RUNNING",
              started["t_ready"] - started["t_start"]),
             ("RUNNING to the first trial",
              trials[0]["datetime_started"] - started["t_ready"])]
    for i, t in enumerate(trials):
        if i:
            parts.append((f"between trials {i} and {i + 1}",
                          t["datetime_started"]
                          - trials[i - 1]["datetime_stopped"]))
        wall = t["datetime_stopped"] - t["datetime_started"]
        fit = sum(m["epoch_time"] for m in c.get_trial_logs(t["id"])[
            "metrics"] if "epoch_time" in m)
        parts += [(f"trial {i + 1} set-up and evaluate", wall - fit),
                  (f"trial {i + 1} epochs", fit)]
    parts.append(("last trial to STOPPED seen",
                  t0 + job_s - trials[-1]["datetime_stopped"]))
    print("process: the train job's time: " + ", ".join(
        f"{label} {sec:.2f} s" for label, sec in parts), flush=True)


def thread_twin(uris: dict, trials: list, store: Path):
    """An admin over thread placement (cuda:0, in-process broker) whose
    store holds the same model and the same two trials (their artifacts),
    with an inference job of them RUNNING; (admin, door, token)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.manager import LocalPlacementManager

    for path in store.parent.glob(store.name + "*"):
        path.unlink()
    db = Database(str(store))
    admin = Admin(db=db, placement=LocalPlacementManager(),
                  params_dir=str(WORK / "process_params"))
    auth = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                   config.SUPERADMIN_PASSWORD)
    model = db.create_model(auth["user_id"], "vit-b16",
                            "IMAGE_CLASSIFICATION",
                            no_checkpoint(TEMPLATE.read_bytes()),
                            "TorchViT", {}, "PRIVATE")
    job = db.create_train_job(auth["user_id"], "vit", 1,
                              "IMAGE_CLASSIFICATION", uris["train"],
                              uris["test"], {"MODEL_TRIAL_COUNT": TRIALS})
    sub = db.create_sub_train_job(job["id"], model["id"])
    for t in trials:
        row = db.create_trial(sub["id"], model["id"], t["knobs"])
        db.mark_trial_as_complete(row["id"], t["score"],
                                  t["params_file_path"])
    db.mark_train_job_as_stopped(job["id"])
    admin.create_inference_job(auth["user_id"], "vit")
    return admin, AdminServer(admin).start(), auth["token"]


def process_phase(card: str, uris: dict, thread_job_s: float):
    """The cycle of phase 5 with every worker a child process
    (``RAFIKI_PLACEMENT=process``): a 2-trial train job in a train child
    whose advisor is the admin's (REST), then the two trials served by two
    children over the shm rings, timed in turns against a thread-placed
    inference job of the same trials. Returns each kernel's launches in
    the children, from their exit lines, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer

    ring, sizes = choose_ring()
    logs = WORK / "process_logs"
    store = WORK / "process.sqlite3"
    for path in [*logs.glob("*"), *WORK.glob("process*.sqlite3*")]:
        path.unlink()
    settings = {"RAFIKI_PLACEMENT": "process", "RAFIKI_LOGS_DIR": str(logs),
                "RAFIKI_SHM_RING_BYTES": str(ring)}
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    print(f"process: RAFIKI_SHM_RING_BYTES={ring} ({ring >> 20} MiB; "
          f"{RING_SEGMENTS} rings); JSON requests of {sizes} images fit "
          f"(a 224x224x3 JSON image is {IMAGE_BYTES_JSON} bytes of f64 in "
          f"the frame)", flush=True)
    kernels = _kernels()
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "process_params"))
    server = twin = twin_server = None
    try:
        require(isinstance(admin.placement, ProcessPlacementManager),
                f"placement {type(admin.placement).__name__}")
        server = AdminServer(admin).start()
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                       no_checkpoint(TEMPLATE.read_bytes()), "TorchViT")
        for kernel in kernels:
            kernel.launches = 0

        # ---- the main path's run (train job in a child) ----
        t0, t0_wall = time.perf_counter(), time.time()
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": TRIALS,
                                                 "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=900,
                                             poll_s=0.05)
        job_s = time.perf_counter() - t0
        # ----------------------------------------------------
        require([k.launches for k in kernels] == [0] * 4,
                f"this process launched {[k.launches for k in kernels]} "
                "while the train child trained")
        require(job["status"] == "STOPPED", f"train job {job['status']}")
        (train_sid,) = [w["service_id"] for w in job["workers"]]
        require(job["workers"][0]["chips"] == [0],
                f"train grant {job['workers'][0]['chips']}")
        trials = [admin.db.get_trial(t["id"])
                  for t in c.get_trials_of_train_job("vit")]
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        require(all(np.isfinite(t["score"]) for t in trials),
                f"scores {[t['score'] for t in trials]}")
        require({t["worker_id"] for t in trials} == {train_sid},
                "trial rows not written by the train child")
        steps = sum((TRAIN_IMAGES // t["knobs"]["batch_size"])
                    * t["knobs"]["epochs"] for t in trials)
        print(f"process: train job of {TRIALS} trials STOPPED in {job_s:.1f}"
              f" s in a child process (Client.create_train_job to STOPPED), "
              f"{thread_job_s:.1f} s for phase 5's thread-placed job; scores "
              f"{[round(t['score'], 4) for t in trials]}; {steps} steps; "
              f"card {card}", flush=True)
        train_timeline(c, trials, t0_wall, job_s,
                       child_records(logs, "startup")[train_sid][0])

        twin, twin_server, twin_token = thread_twin(
            uris, trials, WORK / "process_threads.sqlite3")
        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
        timed = [(kind, n) for kind, n in JSON_TIMED if n in sizes]
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in timed}
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        for kernel in kernels:
            kernel.launches = 0

        # ---- the main path's run (inference job in children) ----
        t0 = time.perf_counter()
        inf = c.create_inference_job("vit")
        deploy_s = time.perf_counter() - t0
        answers = [(n, np.asarray(c.predict("vit", images[:n].tolist())))
                   for n in sizes]
        doors = {"process": (f"http://127.0.0.1:{server.port}/predict/vit",
                             token),
                 "thread": (f"http://127.0.0.1:{twin_server.port}/predict/"
                            "vit", twin_token)}
        lat = {door: {} for door in doors}
        for i, (kind, n) in enumerate(timed):
            for door in sorted(doors, reverse=bool(i % 2)):
                url, auth = doors[door]
                t = time.perf_counter()
                post(url, *bodies[kind, n], token=auth)
                lat[door].setdefault((kind, n), []).append(
                    time.perf_counter() - t)
        c.stop_inference_job("vit")
        # ----------------------------------------------------------
        twin_launches = [k.launches for k in kernels]
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == TRIALS,
                f"inference job {inf['status']}, {len(inf['workers'])} "
                "workers")
        require([w["chips"] for w in inf["workers"]] == [[0]] * TRIALS,
                f"serving grants {[w['chips'] for w in inf['workers']]}")
    finally:
        if twin_server is not None:
            twin_server.stop()
        if twin is not None:
            twin.shutdown()
        if server is not None:
            server.stop()
        admin.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # every child gone, every ring unlinked
    started = child_records(logs, "startup")
    counted = child_records(logs, "kernel launches")
    serving = [w["service_id"] for w in inf["workers"]]
    require(sorted(started) == sorted([train_sid] + serving)
            and all(len(v) == 1 for v in started.values()),
            f"startup lines {started}")
    pids = [r["pid"] for v in started.values() for r in v]
    alive = [pid for pid in pids if _alive(pid)]
    segments = list(Path("/dev/shm").glob(f"{admin.broker.prefix}-*"))
    require(not alive and not segments and os.getpid() not in pids,
            f"after stop: children alive {alive}, segments {segments}")
    print(f"process: after stop_all: children {pids} all exited, no "
          f"/dev/shm/{admin.broker.prefix}-* segment left", flush=True)
    # the grant, cuda:0 here, is the first card this process sees
    parent = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    card0 = parent.split(",")[0].strip() if parent else "0"
    for sid, (rec,) in started.items():
        role = "train" if sid == train_sid else "serving"
        require(rec["cuda_visible_devices"] == card0 and rec["grant"] == [0],
                f"{role} child {sid[:8]} saw CUDA_VISIBLE_DEVICES="
                f"{rec['cuda_visible_devices']!r}, grant {rec['grant']}")
        parts = (("interpreter and package import", "t_start", "t_main"),
                 ("torch import", "t_main", "t_torch"),
                 ("CUDA init", "t_torch", "t_cuda"),
                 ("kernel library load", "t_cuda", "t_kernels"),
                 ("job read and advisor session" if role == "train" else
                  "model load and bucket warm-up", "t_kernels", "t_ready"))
        print(f"process: {role} child {sid[:8]} (pid {rec['pid']}, "
              f"CUDA_VISIBLE_DEVICES={card0}): spawn to RUNNING "
              f"{rec['t_ready'] - rec['t_start']:.2f} s = "
              + " + ".join(f"{label} {rec[b] - rec[a]:.2f}"
                           for label, a, b in parts), flush=True)

    # launches, from the children's exit lines
    sums = {name: 0 for name in KERNEL_NAMES}
    for sid, records in counted.items():
        require(len(records) == 1, f"{sid[:8]}: {len(records)} exit lines")
        got = [records[0][attr] for attr in (
            "flash_attention", "flash_attention_lse", "flash_attention_dq",
            "flash_attention_dkv")]
        forwards = len(buckets) + len(sizes) + len(timed)
        expect = ([DEPTH * TRIALS] + [DEPTH * steps] * 3 if sid == train_sid
                  else [DEPTH * forwards, 0, 0, 0])
        require(got == expect, f"child {sid[:8]} launches {got}, expected "
                f"{expect}")
        for name, n in zip(KERNEL_NAMES, got):
            sums[name] += n
    # the twin warmed up before the counts were zeroed
    twin_expect = [DEPTH * TRIALS * len(timed), 0, 0, 0]
    require(twin_launches == twin_expect,
            f"thread twin launches {twin_launches}, expected {twin_expect}")
    print(f"process: launches in the children (exit lines): train child "
          f"K1 {DEPTH * TRIALS} ({TRIALS} evaluates), K1-LSE = K2 = K3 = "
          f"{DEPTH * steps} ({steps} steps); each serving child K1 "
          f"{DEPTH * (len(buckets) + len(sizes) + len(timed))} "
          f"({len(buckets)} warm-up buckets + {len(sizes) + len(timed)} "
          f"requests); none in this process but the thread twin's "
          f"{twin_launches[0]}", flush=True)

    cfg = vit.vit_b16()
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
    refs = []
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        for t in trials:
            tree = load_params(read_artifact(t["params_file_path"]))
            m = convert.from_jax_params(tree, plain_cfg, "cuda:0")
            refs.append(torch.softmax(m(x), -1).double().cpu().numpy())
            del m
    ref = sum(refs) / len(refs)
    for n, probs in answers:
        require(probs.shape == (n, cfg.num_classes),
                f"process /predict/vit {n}: shape {probs.shape}")
        require(bool(np.isfinite(probs).all()),
                f"process /predict/vit {n}: non-finite")
        held = prob_check(f"process /predict/vit {n}", probs, ref[:n])
        print(f"process: Client.predict of {n} (JSON) answered by the "
              f"serving children: {held}; against the plain-attention "
              f"ensemble of the trials", flush=True)
    p50 = {door: p50_ms(v) for door, v in lat.items()}
    print(f"process: inference job RUNNING in {deploy_s:.1f} s (2 serving "
          f"children spawned, loaded and warmed); /predict/vit p50 of the "
          f"same JSON bodies in turns, process vs thread placement: "
          + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                      f"{p50['process']['json', n]:.2f} vs "
                      f"{p50['thread']['json', n]:.2f} ms"
                      for n in sizes)
          + f" ({len(timed) // len(sizes)} requests of each size a door, "
          f"sequential); card {card}", flush=True)
    return [sums[name] for name in KERNEL_NAMES]


# ---------------------------------------------------------------------------
# phase 7: the image-classification zoo
# ---------------------------------------------------------------------------

TEMPLATES = REPO / "rafiki_tpu_torch" / "templates"
#: the six twins of the JAX package's image-classification templates
ZOO_TWINS = (("torch_feedforward", "TorchFeedForward"),
             ("torch_cnn", "TorchCnn"), ("torch_vgg16", "TorchVgg16"),
             ("torch_resnet", "TorchResNet"),
             ("np_decision_tree", "NpDecisionTree"),
             ("np_linear_svm", "NpLinearSvm"))
ZOO_SMALL = (512, 128)         # 7a: train and test images
#: 7b: 1/10 of CIFAR-10's own train and test sizes (50,000 + 10,000), cut
#: for the run's time limit (1/5 until phase 17)
CIFAR_SIZES = (5_000, 1_000)
#: TorchResNet with the plan and the epochs fixed: the GP tunes the
#: learning rate and the batch size
RESNET50 = """

class TorchResNet50(TorchResNet):
    @staticmethod
    def get_knob_config():
        knobs = TorchResNet.get_knob_config()
        knobs.update(depth=FixedKnob("resnet50"), epochs=FixedKnob(1))
        return knobs
"""
# the served ensemble against the mean of its trials' own predict on the
# card: the same forward at the same bucket (8), the mean taken in f64 by
# both; and one image alone (padded to the 8-bucket with copies of
# itself) against its row in a batch of 8: in evaluation mode BatchNorm
# uses the running statistics, so only cuDNN's choice of algorithm for
# another batch's contents may move a bf16 logit
ENSEMBLE_ATOL = 1e-3
ALONE_ATOL = 2e-2
ZOO_TIMED = [1] * 10 + [64] * 10  # JSON requests on /predict/<app>


def synthetic_cifar(rng: np.random.Generator, protos: np.ndarray, n: int):
    """``n`` CIFAR-10-shaped images (32x32x3 uint8) and labels: each
    class's 8x8x3 prototype blown up 4x, x 55 + 128, plus N(0, 14) noise
    (the synthetic set of ``examples/datasets/image_classification/
    load_cifar10.py``)."""
    y = rng.integers(0, len(protos), n)
    x = np.kron(protos[y], np.ones((1, 4, 4, 1), np.float32))
    x = x * 55.0 + 128.0 + rng.normal(scale=14.0, size=x.shape)
    return np.clip(x, 0, 255).astype(np.uint8), y


def zoo_datasets(name: str, sizes: tuple, seed: int) -> tuple:
    """Image-zip train and test sets under ``build/chip_smoke/zoo/``, and
    the test images as [0, 1] floats."""
    from rafiki_tpu_torch.sdk.dataset import write_image_files_dataset

    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(CLASSES, 8, 8, 3)).astype(np.float32)
    out = WORK / "zoo"
    out.mkdir(parents=True, exist_ok=True)
    uris = []
    for split, n in zip(("train", "test"), sizes):
        x, y = synthetic_cifar(rng, protos, n)
        uris.append(write_image_files_dataset(
            x, y, str(out / f"{name}_{split}.zip")))
    return uris[0], uris[1], x.astype(np.float32) / 255


def zoo_contract(card: str) -> None:
    """7a: ``test_model_class`` of each twin on cuda:0, its knobs proposed
    by the port's advisor."""
    from rafiki_tpu_torch.sdk import model as sdk_model

    t0 = time.perf_counter()
    train, test, x = zoo_datasets("small", ZOO_SMALL, SEED + 70)
    print(f"zoo: image-zip sets of {ZOO_SMALL[0]} + {ZOO_SMALL[1]} images "
          f"(32x32x3) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for module, class_name in ZOO_TWINS:
        t0 = time.perf_counter()
        preds = np.asarray(sdk_model.test_model_class(
            model_file_path=str(TEMPLATES / f"{module}.py"),
            model_class=class_name, task="IMAGE_CLASSIFICATION",
            train_dataset_uri=train, test_dataset_uri=test,
            queries=x[:2].tolist()))
        require(preds.shape == (2, CLASSES) and np.isfinite(preds).all()
                and np.allclose(preds.sum(-1), 1, atol=1e-4),
                f"{class_name} predictions {preds}")
        print(f"zoo: test_model_class {class_name} OK on "
              f"{torch.cuda.get_device_name(0)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"zoo: the six twins passed test_model_class; card {card}",
          flush=True)


def trial_split(logs: list, wall: float) -> str:
    """Where a trial's wall time went, from its logged metrics: the
    template's ``read_time`` and ``init_time``, ``fit``'s ``upload_time``
    and ``epoch_time``, and the worker's phase breakdown
    (``trace_{train,evaluate,persist_params}_s``)."""
    m = {}
    for record in logs:
        for key, value in record.items():
            if key.endswith(("_time", "_s")):
                m[key] = m.get(key, 0.0) + value
    inside = [("dataset read and decode", "read_time"),
              ("parameter init", "init_time"), ("upload", "upload_time"),
              ("epochs", "epoch_time")]
    parts = inside + [
        ("the rest of train()", m.get("trace_train_s", 0.0)
         - sum(m.get(key, 0.0) for _, key in inside)),
        ("evaluate", "trace_evaluate_s"),
        ("artifact write", "trace_persist_params_s")]
    seconds = [(label, m.get(key, 0.0) if isinstance(key, str) else key)
               for label, key in parts]
    rest = wall - sum(v for _, v in seconds)
    return ", ".join(f"{label} {v:.2f} s" for label, v in seconds) + (
        f", outside the phases {rest:.2f} s")


def zoo_step_time(card: str, batch: int, train_uri: str) -> None:
    """The ResNet-50 train step at ``batch``, per call and on the card,
    and a kernel profile of one step."""
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.models import resnet
    from rafiki_tpu_torch.sdk.dataset import dataset_utils
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_resnet

    x, y = dataset_utils.load_image_arrays(train_uri, image_size=(32, 32))
    cfg = resnet.resnet50(num_classes=CLASSES, small_inputs=True)
    with torch.device("meta"):
        model = resnet.ResNet(cfg)
    model = from_jax_tree(model, *resnet.init(np.random.default_rng(0), cfg),
                          "cuda:0", train=True)
    state = model.state()
    trainer = DataParallelTrainer(
        torch_resnet._loss, tunable_optimizer(
            torch.optim.AdamW, lr=1e-4, weight_decay=1e-4),
        device="cuda:0", stateful=True)
    opt = trainer.optimizer(model.parameters())
    data = (torch.from_numpy(x[:batch]).cuda(),
            torch.from_numpy(y[:batch]).cuda())
    step = lambda: trainer.train_step(model, opt, data, state)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
    print(f"zoo: ResNet-50 train step at batch {batch} (32x32x3, bf16): "
          f"{call_ms:.2f} ms per call, {card_ms:.2f} ms on the card; "
          f"{batch / call_ms * 1e3:.0f} images/s per call "
          f"({batch / card_ms * 1e3:.0f} on the card); card {card}",
          flush=True)
    print_device_profile(step, f"batch-{batch} ResNet-50 train step")
    del model, opt, state, data


def zoo_phase(card: str) -> list:
    """7a, then 7b: a 2-trial ResNet-50 job on a CIFAR-10-shaped image-zip
    set through ``Client`` (GP over the learning rate and the batch
    size), served. Returns each kernel's launches on this path, in
    ``KERNEL_NAMES`` order (none is on it)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params

    t_phase = time.perf_counter()
    zoo_contract(card)
    t0 = time.perf_counter()
    train_uri, test_uri, x = zoo_datasets("cifar", CIFAR_SIZES, SEED + 71)
    mb = sum(Path(u).stat().st_size for u in (train_uri, test_uri)) / 1e6
    print(f"zoo: CIFAR-10-shaped synthetic set ({CIFAR_SIZES[0]} + "
          f"{CIFAR_SIZES[1]} images, 32x32x3, {CLASSES} classes) made and "
          f"written as image zips (PNG, filter 0) in "
          f"{time.perf_counter() - t0:.1f} s ({mb:.0f} MB)", flush=True)

    store = WORK / "zoo.sqlite3"
    for path in WORK.glob("zoo.sqlite3*"):
        path.unlink()
    source = (TEMPLATES / "torch_resnet.py").read_text() + RESNET50
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "zoo_params"))
    server = AdminServer(admin).start()
    kernels = _kernels()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("resnet50", "IMAGE_CLASSIFICATION",
                               source.encode(), "TorchResNet50")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchResNet50 upload not verified: "
                f"{model['verification']}")

        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("cifar", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": TRIALS,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("cifar", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        trials = c.get_trials_of_train_job("cifar")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        for t in trials:
            require(np.isfinite(t["score"]) and t["score"] > 1 / CLASSES,
                    f"trial score {t['score']} not above chance")
            wall = t["datetime_stopped"] - t["datetime_started"]
            print(f"zoo: trial {t['id'][:8]} COMPLETED: learning_rate "
                  f"{t['knobs']['learning_rate']:.3g}, batch_size "
                  f"{t['knobs']['batch_size']}, test accuracy "
                  f"{t['score']:.4f}; {wall:.2f} s in the trial: "
                  f"{trial_split(c.get_trial_logs(t['id'])['metrics'], wall)}",
                  flush=True)
        print(f"zoo: train job of {TRIALS} ResNet-50 trials (1 epoch of "
              f"{CIFAR_SIZES[0]} images each, GP) STOPPED in {job_s:.1f} s "
              f"(Client.create_train_job to STOPPED); card {card}",
              flush=True)
        best = max(trials, key=lambda t: t["score"])
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]

        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/cifar"
        bodies = {n: request_body("json", x[:n]) for n in set(ZOO_TIMED)}
        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("cifar")
        deploy_s = time.perf_counter() - t0
        batch8 = np.asarray(c.predict("cifar", x[:8].tolist()))
        alone = np.concatenate([np.asarray(c.predict(
            "cifar", x[i:i + 1].tolist())) for i in range(8)])
        lat = {}
        for n in ZOO_TIMED:
            t = time.perf_counter()
            post(url, *bodies[n], token=token)
            lat.setdefault(("json", n), []).append(time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("cifar")
        c.stop_inference_job("cifar")
        require(inf["status"] == "RUNNING"
                and len(inf["workers"]) == TRIALS,
                f"inference job {inf['status']} with "
                f"{len(inf['workers'])} workers")
        p50 = p50_ms(lat)
        print(f"zoo: inference job RUNNING in {deploy_s:.1f} s (deploy and "
              f"warm-up of {TRIALS} ResNet-50 workers on "
              f"{[w['chips'] for w in inf['workers']]}); p50 of "
              f"/predict/cifar (JSON, admin door, sequential): "
              + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                          f"{p50['json', n]:.2f} ms" for n in (1, 64))
              + f" ({ZOO_TIMED.count(1)} requests each); serving stats "
              f"{stats['batches']} batches, {stats['queries']} queries; "
              f"card {card}", flush=True)
    finally:
        server.stop()
        admin.shutdown()

    clazz = load_model_class(source.encode(), "TorchResNet50")
    refs = []
    for t, blob in zip(trials, blobs):
        m = clazz(**t["knobs"])
        m.load_parameters(blob)
        refs.append(np.asarray(m.predict(x[:8]), np.float64))
        del m
    mean = sum(refs) / len(refs)
    for label, got in (("batch of 8", batch8), ("one at a time", alone)):
        require(got.shape == (8, CLASSES) and np.isfinite(got).all(),
                f"/predict/cifar {label}: {got.shape}")
    err = float(np.abs(batch8 - mean).max())
    require(err <= ENSEMBLE_ATOL, f"ensemble off its trials' mean by "
            f"{err:.3g} (tol {ENSEMBLE_ATOL:g})")
    err_alone = float(np.abs(alone - batch8).max())
    require(err_alone <= ALONE_ATOL, f"one image alone off its row in the "
            f"batch by {err_alone:.3g} (tol {ALONE_ATOL:g})")
    agree = float((batch8.argmax(-1) == mean.argmax(-1)).mean())
    print(f"zoo: Client.predict of 8 images: the ensemble within "
          f"{err:.3g} of the mean of its {TRIALS} trials' predict on the "
          f"card (tol {ENSEMBLE_ATOL:g}; argmax agreement {agree:.2f}); each "
          f"image alone within {err_alone:.3g} of its row in the batch "
          f"(tol {ALONE_ATOL:g})", flush=True)
    zoo_step_time(card, best["knobs"]["batch_size"], train_uri)
    counts = [a + b for a, b in zip(train_counts, serve_counts)]
    require(counts == [0] * len(KERNEL_NAMES),
            f"the zoo path launched attention kernels: {counts}")
    print(f"zoo: phase 7 took {time.perf_counter() - t_phase:.0f} s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 8: text
# ---------------------------------------------------------------------------

#: train and test sentences: SST-2's test size, its train set (6,920)
#: cut to a third for the run's time limit
SST2_SIZES = (2300, 1821)
SENTENCE_TOKENS = (5, 40)
POOL_WORDS = 1000          # each class's words; the pools are disjoint
#: TorchBert at BERT-base's published widths (12 x 768, 12 heads, the
#: uncased vocabulary of 30,522) on 128-token sequences, one epoch; the GP
#: tunes the learning rate (the fine-tuning decade) and the batch size
BERT_BASE = """

class TorchBertBase(TorchBert):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchBert.get_knob_config())
        cfg["depth"] = FixedKnob(12)
        cfg["heads"] = FixedKnob(12)
        cfg["dim"] = FixedKnob(768)
        cfg["max_len"] = FixedKnob(128)
        cfg["vocab"] = FixedKnob(30522)
        cfg["epochs"] = FixedKnob(1)
        cfg["learning_rate"] = FloatKnob(5e-5, 5e-4, is_exp=True)
        return cfg
"""
#: Adam steps on the (8, 512) pattern rows: after 4 the loss was still
#: ~ln(32,000) (10.30), and a sampled stream's distribution spread over
#: thousands of tokens, whose cumulative boundaries lie closer together
#: than two f32 computations of it may differ; a few dozen steps make it
#: peaked on the learnt sequence, so its draws can be held token by token
LM_STEPS = 40
#: TorchGenLM at LMConfig's defaults (vocab 32,000, 2,048 positions,
#: 12 x 768, 12 heads, causal), trained LM_STEPS Adam steps on (8, 512)
LM_FULL = f"""

class TorchGenLMFull(TorchGenLM):
    generation_spec = GenerationSpec(eos_token_id=None, max_context=2048)
    arch = {{"vocab": 32000, "depth": 12, "heads": 12}}
    training = (8, 512, {LM_STEPS})

    @staticmethod
    def get_knob_config():
        cfg = dict(TorchGenLM.get_knob_config())
        cfg["lr"] = FixedKnob(1e-3)
        cfg["dim"] = FixedKnob(768)
        return cfg
"""
TEXT_TIMED = [1] * 10 + [8] * 10 + [64] * 10  # JSON on /predict/<app>
PREDICT_BUCKETS = 4                # a worker's warm-up: 8, 16, 32, 64
EVAL_BATCH = 256                   # predict_batched's default chunk
# generation traffic: 8 concurrent streams, prompts of 128-512 tokens of
# the training sequence, half of them sharing a 256-token prefix, 64
# tokens each
STREAMS, SHARED_PREFIX, PROMPT_TOKENS, GEN_TOKENS = 8, 256, (128, 512), 64
SAMPLING = {"temperature": 0.8, "top_p": 0.95}
# a pool too small for the 8 streams at once (each holds up to 36 pages
# of 16 tokens): the scheduler must preempt
SMALL_POOL_BLOCKS = 144
# a greedy token is compared where the f32 reference's top two logits
# differ by at least this; a sampled one where its uniform lies at least
# this far from every cumulative boundary of the reference distribution.
# Past the first position under either margin, two f32 computations in
# other orders may rightly differ, and the stream is compared no further
TIE_GAP = 1e-4
DRAW_MARGIN = 1e-5


def text_corpus():
    """SST-2-shaped synthetic corpus zips under ``build/chip_smoke/text/``:
    two classes, each sentence 5-40 words of its class's pool (the pools
    disjoint), the label in the first tag column. Returns the train and
    test URIs and the test sentences as strings."""
    from rafiki_tpu_torch.sdk.dataset import write_corpus_dataset

    rng = np.random.default_rng(SEED + 80)
    pools = [[f"{c}{i}" for i in range(POOL_WORDS)] for c in "np"]
    out = WORK / "text"
    out.mkdir(parents=True, exist_ok=True)
    uris = []
    for split, n in zip(("train", "test"), SST2_SIZES):
        sentences = []
        for y in rng.integers(0, 2, n):
            k = int(rng.integers(SENTENCE_TOKENS[0], SENTENCE_TOKENS[1] + 1))
            words = [str(w) for w in rng.choice(pools[y], k)]
            sentences.append((words, [[("negative", "positive")[y]]] * k))
        uris.append(write_corpus_dataset(
            sentences, str(out / f"sst2_{split}.zip")))
    return uris[0], uris[1], [" ".join(w) for w, _ in sentences]


def _stack(name: str, port_store: str, fresh: bool = True,
           inventory: list = None):
    """An admin (thread placement over the visible card, or over
    ``inventory``), its REST door and a function that makes a logged-in
    Client, on a fresh store under ``build/chip_smoke/`` (or, without
    ``fresh``, on the one there)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database

    for path in WORK.glob(f"{port_store}*") if fresh else ():
        path.unlink()
    placement = None
    if inventory is not None:
        from rafiki_tpu_torch.placement.manager import (
            ChipAllocator,
            LocalPlacementManager,
        )

        placement = LocalPlacementManager(ChipAllocator(inventory))
    admin = Admin(db=Database(str(WORK / port_store)), placement=placement,
                  params_dir=str(WORK / f"{name}_params"))
    server = AdminServer(admin).start()

    def new_client():
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        return c

    return admin, server, new_client


def bert_phase(card: str) -> list:
    """8a: a 2-trial BERT-base job on the SST-2-shaped corpus through
    ``Client``, served; returns each kernel's launches on this path."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.models import bert
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    t0 = time.perf_counter()
    train_uri, test_uri, queries = text_corpus()
    print(f"bert: SST-2-shaped synthetic corpus ({SST2_SIZES[0]} + "
          f"{SST2_SIZES[1]} sentences of {SENTENCE_TOKENS[0]}-"
          f"{SENTENCE_TOKENS[1]} words, two disjoint pools of {POOL_WORDS}) "
          f"written as corpus zips in {time.perf_counter() - t0:.1f} s",
          flush=True)
    source = no_checkpoint(
        (TEMPLATES / "torch_bert.py").read_bytes()).decode() + BERT_BASE
    admin, server, new_client = _stack("text", "text.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        model = c.create_model("bert-base", "TEXT_CLASSIFICATION",
                               source.encode(), "TorchBertBase")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchBertBase upload not verified: "
                f"{model['verification']}")
        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("sst2", "TEXT_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": TRIALS,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("sst2", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        trials = c.get_trials_of_train_job("sst2")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        steps = 0
        for t in trials:
            require(np.isfinite(t["score"]) and t["score"] > 0.5,
                    f"trial score {t['score']} not above chance")
            batch = t["knobs"]["batch_size"]
            steps += SST2_SIZES[0] // batch
            wall = t["datetime_stopped"] - t["datetime_started"]
            epochs = [m for m in c.get_trial_logs(t["id"])["metrics"]
                      if "epoch_time" in m]
            print(f"bert: trial {t['id'][:8]} COMPLETED: learning_rate "
                  f"{t['knobs']['learning_rate']:.3g}, batch_size {batch}, "
                  f"epoch loss {epochs[-1]['loss']:.4f} in "
                  f"{epochs[-1]['epoch_time']:.2f} s "
                  f"({SST2_SIZES[0] // batch} steps), test accuracy "
                  f"{t['score']:.4f}; {wall:.2f} s in the trial", flush=True)
        forwards = TRIALS * -(-SST2_SIZES[1] // EVAL_BATCH)
        expect = [DEPTH * forwards] + [DEPTH * steps] * 3
        print(f"bert: train job of {TRIALS} BERT-base trials (1 epoch, GP) "
              f"STOPPED in {job_s:.1f} s (Client.create_train_job to "
              f"STOPPED); {steps} steps, {forwards} evaluate forwards; "
              f"launches K1 {train_counts[0]}, K1-LSE {train_counts[1]}, "
              f"K2 {train_counts[2]}, K3 {train_counts[3]} (expected "
              f"{expect}); card {card}", flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/sst2"
        bodies = {n: (json.dumps({"queries": queries[:n]}).encode(),
                      {"Content-Type": "application/json"})
                  for n in set(TEXT_TIMED)}
        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("sst2")
        deploy_s = time.perf_counter() - t0
        batch8 = np.asarray(c.predict("sst2", queries[:8]))
        lat = {}
        for n in TEXT_TIMED:
            t = time.perf_counter()
            post(url, *bodies[n], token=token)
            lat.setdefault(("json", n), []).append(time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("sst2")
        c.stop_inference_job("sst2")
    finally:
        server.stop()
        admin.shutdown()
    require(inf["status"] == "RUNNING" and len(inf["workers"]) == TRIALS,
            f"inference job {inf['status']} with {len(inf['workers'])} "
            "workers")
    forwards = stats["batches"] + PREDICT_BUCKETS * TRIALS
    expect = [DEPTH * forwards, 0, 0, 0]
    require(serve_counts == expect,
            f"serving launches {serve_counts}, expected {expect}")
    p50 = p50_ms(lat)
    print(f"bert: inference job RUNNING in {deploy_s:.1f} s ({TRIALS} "
          f"workers on {[w['chips'] for w in inf['workers']]}); p50 of "
          f"/predict/sst2 (JSON, admin door, sequential): "
          + ", ".join(f"{n} sentence{'s' if n > 1 else ''} "
                      f"{p50['json', n]:.2f} ms" for n in (1, 8, 64))
          + f"; K1 launched {serve_counts[0]} times in {forwards} bucketed "
          f"forwards ({DEPTH} a forward); card {card}", flush=True)

    # the served answers against each trial's own predict on the card and
    # against the plain-attention forward of the same parameters
    clazz = load_model_class(source.encode(), "TorchBertBase")
    own, plain = [], []
    for t, blob in zip(trials, blobs):
        m = clazz(**t["knobs"])
        m.load_parameters(blob)
        own.append(np.asarray(m.predict(queries[:8]), np.float64))
        plain_cfg = dataclasses.replace(m._cfg, encoder=dataclasses.replace(
            m._cfg.encoder, use_flash=False))
        m._model = convert.from_jax_params(blob["params"], plain_cfg,
                                           "cuda:0")
        plain.append(np.asarray(m.predict(queries[:8]), np.float64))
        del m
    require(batch8.shape == (8, 2) and np.isfinite(batch8).all(),
            f"/predict/sst2 answered {batch8.shape}")
    err = float(np.abs(batch8 - sum(own) / TRIALS).max())
    require(err <= ENSEMBLE_ATOL, f"ensemble off its trials' mean by "
            f"{err:.3g} (tol {ENSEMBLE_ATOL:g})")
    # phase 12 serves these trials again, fused
    BERT_RUN.update(queries=queries, batch8=batch8, own8=sum(own) / TRIALS,
                    p50_8=p50["json", 8],
                    own_by_trial={t["id"]: o for t, o in zip(trials, own)})
    print(f"bert: Client.predict of 8 sentences: the ensemble within "
          f"{err:.3g} of its trials' mean (tol {ENSEMBLE_ATOL:g}); against "
          f"the plain-attention forward: "
          + prob_check("bert /predict/sst2", batch8, sum(plain) / TRIALS),
          flush=True)

    # one train step through the kernels against plain attention from the
    # initial weights, in f32 and in bf16 (text_step_gates); then the
    # step's time at batch 32
    cfg = clazz(**trials[0]["knobs"])._make_cfg(2)
    x, y = clazz(**trials[0]["knobs"])._load(train_uri)
    tree = bert.init(np.random.default_rng(0), cfg)
    loss_fn = softmax_classifier_loss(lambda m, ids: m(ids))
    batch = (torch.from_numpy(x[:32]).cuda(), torch.from_numpy(y[:32]).cuda())

    def loss_of(model, dtype):
        return torch.nn.functional.cross_entropy(
            model(batch[0], dtype), batch[1].long())

    text_step_gates("bert: one step at batch 32 (S=128)", cfg, tree, loss_of)
    trainer = DataParallelTrainer(loss_fn, tunable_optimizer(
        torch.optim.AdamW, lr=1e-4, weight_decay=1e-4))
    model, opt = trainer.init(lambda rng: convert.from_jax_params(
        tree, cfg, "cuda:0", train=True))
    step = lambda: trainer.train_step(model, opt, batch)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
    print(f"bert: BERT-base train step at batch 32 x 128 tokens: "
          f"{call_ms:.2f} ms per call, {card_ms:.2f} ms on the card "
          f"({32 * 128 / card_ms * 1e3:.0f} tokens/s); card {card}",
          flush=True)
    print_device_profile(step, "batch-32 BERT-base train step", shares=(
        ("K1-LSE", "flash_fwd_wgmma_kernel"),
        ("K2", "flash_bwd_dq_wgmma_kernel"),
        ("K3", "flash_bwd_dkv_wgmma_kernel")))
    del model, opt
    return [a + b for a, b in zip(train_counts, serve_counts)]


def lm_prompts(rng: np.random.Generator, vocab: int) -> list:
    """STREAMS prompts of PROMPT_TOKENS tokens from the sequence the LM
    was trained on (``_pattern_batch``: token (3 b + 2) mod vocab at
    position b); the first half start at its beginning, so they share a
    SHARED_PREFIX-token prefix, the others at random offsets."""
    out = []
    for i in range(STREAMS):
        n = int(rng.integers(PROMPT_TOKENS[0], PROMPT_TOKENS[1] + 1))
        if i < STREAMS // 2:
            start, n = 0, max(n, SHARED_PREFIX + 1)
        else:
            start = int(rng.integers(SHARED_PREFIX, 4096 - n - GEN_TOKENS))
        out.append(((3 * np.arange(start, start + n) + 2) % vocab).tolist())
    return out


def generate_pass(c, app: str, prompts: list, **kw) -> dict:
    """STREAMS concurrent ``Client.generate`` streams of GEN_TOKENS
    tokens; returns the streams, each one's time to first token, and the
    pass's seconds. ``kw`` rides every request; a ``seeds`` list gives
    each stream its own seed."""
    seeds = kw.pop("seeds", None)
    out = {"tokens": [None] * len(prompts), "ttft": [None] * len(prompts)}
    errors = []

    def run(i):
        try:
            extra = dict(kw, seed=seeds[i]) if seeds else kw
            t0 = time.perf_counter()
            toks = []
            for d in c.generate(app, prompts[i], max_tokens=GEN_TOKENS,
                                timeout_s=300, **extra):
                if not toks and d["tokens"]:
                    out["ttft"][i] = time.perf_counter() - t0
                toks += d["tokens"]
            out["tokens"][i] = toks
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"stream {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    out["seconds"] = time.perf_counter() - t0
    require(not errors and not any(th.is_alive() for th in threads),
            f"generation pass failed: {errors}")
    require(all(len(t) == GEN_TOKENS for t in out["tokens"]),
            f"streams of {[len(t) for t in out['tokens']]} tokens")
    return out


def serve_lm(new_client, app: str, env: dict, passes):
    """Deploy ``app`` with ``env`` set, run ``passes(c)`` on a fresh
    client (a client caches the door it resolved, and each deployment has
    its own), read the worker's stats once its slots are empty, stop the
    job. Returns (passes' result, stats, deploy seconds)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    c = new_client()
    try:
        t0 = time.perf_counter()
        inf = c.create_inference_job(app)
        deploy_s = time.perf_counter() - t0
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == 1
                and inf["predictor_port"], f"inference job {inf}")
        result = passes(c)
        deadline = time.monotonic() + 30
        while True:
            stats = c.get_inference_job_stats(app)["workers"][0]
            if stats.get("gen_resident_streams", 1) == 0 \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        c.stop_inference_job(app)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result, stats, deploy_s


def lm_reference(model, prompts: list, streams: list):
    """Each stream's f32 plain-attention reference, teacher-forced on the
    stream itself: (the logits that predict each generated token, the gap
    between their top two)."""
    out = []
    with torch.inference_mode():
        for p, s in zip(prompts, streams):
            ids = torch.tensor([p + s[:-1]], device=model.pos.device)
            logits = model(ids, dtype=torch.float32)[0, len(p) - 1:]
            top2 = logits.topk(2, dim=-1).values
            out.append((logits, (top2[:, 0] - top2[:, 1]).cpu().numpy()))
    return out


def compared_greedy(stream: list, ref) -> int:
    """Positions at which a greedy stream was held against its reference
    (up to the first whose top-2 gap is under TIE_GAP); raises at a
    mismatch before it."""
    logits, gaps = ref
    want = logits.argmax(-1).tolist()
    for i, (got, w) in enumerate(zip(stream, want)):
        if gaps[i] < TIE_GAP:
            return i
        require(got == w, f"greedy token {i} is {got}, the f32 reference's "
                f"argmax {w} (top-2 gap {gaps[i]:.3g})")
    return len(stream)


def compared_sampled(stream: list, ref, prompt: list, seed: int) -> int:
    """Positions at which a sampled stream was held against the draw from
    its f32 reference distribution under the same key (up to the first
    whose uniform lies within DRAW_MARGIN of a cumulative boundary)."""
    from rafiki_tpu_torch.models import lm

    logits, _ = ref
    n = len(stream)
    probs = lm.modified_dist(logits, np.full(n, SAMPLING["temperature"]),
                             np.zeros(n, np.int64),
                             np.full(n, SAMPLING["top_p"]))
    positions = len(prompt) + np.arange(n)
    u = lm._uniform_at(np.full(n, seed, np.uint32), positions,
                       lm.ROLE_TARGET)
    u = torch.from_numpy(u).to(probs.device)
    want = lm.sample_from(probs, u).tolist()
    margin = (probs.cumsum(-1) - u[:, None]).abs()
    margin = margin.min(-1).values.cpu().numpy()
    for i, (got, w) in enumerate(zip(stream, want)):
        if margin[i] < DRAW_MARGIN:
            return i
        require(got == w, f"sampled token {i} is {got}, the reference's "
                f"draw {w} (margin {margin[i]:.3g})")
    return n


def same_until(a: list, b: list, upto: int, what: str) -> None:
    require(a[:upto] == b[:upto], f"{what} differ in their first {upto} "
            "tokens")


def lm_phase(card: str) -> list:
    """8b: the LM at full width trained through ``Client`` under
    ``TEXT_GENERATION``, then served on its own door: greedy, binary,
    sampled, ring and preempted passes of 8 concurrent streams. Returns
    each kernel's launches on this path."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.templates.torch_gen_lm import _pattern_batch

    source = (TEMPLATES / "torch_gen_lm.py").read_text() + LM_FULL
    admin, server, new_client = _stack("lm", "text_lm.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        model = c.create_model("lm", "TEXT_GENERATION", source.encode(),
                               "TorchGenLMFull")
        require(model["verification"] is not None
                and model["verification"]["ok"]
                and model["verification"]["capabilities"]["generation"],
                f"TorchGenLMFull upload: {model['verification']}")
        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("lm", "TEXT_GENERATION", "pattern://train",
                           "pattern://test",
                           budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("lm", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        (trial,) = c.get_trials_of_train_job("lm")
        require(trial["status"] == "COMPLETED"
                and np.isfinite(trial["score"]),
                f"trial {trial['status']} {trial['score']}")
        expect = [DEPTH] + [DEPTH * LM_STEPS] * 3
        print(f"lm: train job (1 trial, {LM_STEPS} Adam steps on (8, 512), "
              f"causal) STOPPED in {job_s:.1f} s; loss after training "
              f"{-trial['score']:.4f}; launches K1 {train_counts[0]}, "
              f"K1-LSE {train_counts[1]}, K2 {train_counts[2]}, K3 "
              f"{train_counts[3]} (expected {expect}); card {card}",
              flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")
        blob = load_params(c.download_trial_params(trial["id"]))
        clazz = load_model_class(source.encode(), "TorchGenLMFull")
        cfg = clazz(**trial["knobs"])._cfg
        batch = tuple(torch.from_numpy(a).cuda() for a in _pattern_batch(
            *clazz.training[:2], cfg.vocab))
        tree = lm.init(np.random.default_rng(0), cfg)

        def loss_of(model, dtype):
            return torch.nn.functional.cross_entropy(
                model(batch[0], dtype)[:, :-1].flatten(0, 1),
                batch[0][:, 1:].flatten().long())

        text_step_gates("lm: one step at (8, 512), causal", cfg, tree,
                        loss_of)
        del tree
        prompts = lm_prompts(np.random.default_rng(SEED + 81), cfg.vocab)
        seeds = list(range(1, STREAMS + 1))

        # ---- the main path's run (serving): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        door = {"RAFIKI_PREDICTOR_PORTS": "1"}

        def paged_passes(c):
            return {"greedy": generate_pass(c, "lm", prompts),
                    "binary": generate_pass(c, "lm", prompts, binary=True),
                    "sampled": generate_pass(c, "lm", prompts, seeds=seeds,
                                             **SAMPLING),
                    "sampled again": generate_pass(c, "lm", prompts,
                                                   seeds=seeds, **SAMPLING)}

        paged, paged_stats, deploy_s = serve_lm(new_client, "lm", door,
                                                paged_passes)
        ring, ring_stats, _ = serve_lm(
            new_client, "lm", {**door, "RAFIKI_GEN_KV_PAGED": "0"},
            lambda c: generate_pass(c, "lm", prompts))
        small, small_stats, _ = serve_lm(
            new_client, "lm", {**door, "RAFIKI_GEN_KV_POOL_BLOCKS":
                      str(SMALL_POOL_BLOCKS)},
            lambda c: generate_pass(c, "lm", prompts, seeds=seeds,
                                    **SAMPLING))
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
    finally:
        server.stop()
        admin.shutdown()
    require(serve_counts == [0, 0, 0, 0], f"attention kernels launched "
            f"while serving generation: {serve_counts}")

    greedy = paged["greedy"]
    ttft = sorted(greedy["ttft"])
    print(f"lm: {STREAMS} concurrent Client.generate streams of "
          f"{GEN_TOKENS} tokens, prompts {sorted(len(p) for p in prompts)} "
          f"tokens ({STREAMS // 2} sharing a {SHARED_PREFIX}-token prefix), "
          f"paged KV (deploy {deploy_s:.1f} s): time to first token p50 "
          f"{statistics.median(ttft) * 1e3:.1f} ms, p95 "
          f"{np.percentile(ttft, 95) * 1e3:.1f} ms; "
          f"{STREAMS * GEN_TOKENS / greedy['seconds']:.0f} tokens/s in all "
          f"({greedy['seconds']:.2f} s the pass; sampled "
          f"{STREAMS * GEN_TOKENS / paged['sampled']['seconds']:.0f}, ring "
          f"{STREAMS * GEN_TOKENS / ring['seconds']:.0f}, small pool "
          f"{STREAMS * GEN_TOKENS / small['seconds']:.0f}); card {card}",
          flush=True)
    for name, stats in (("paged", paged_stats), ("ring", ring_stats),
                        ("small pool", small_stats)):
        print(f"lm: {name} worker stats: " + ", ".join(
            f"{k[4:]} {v}" for k, v in sorted(stats.items())
            if k.startswith("gen_") and k != "gen_job"), flush=True)
        require(stats["gen_slots_busy"] == 0
                and stats["gen_resident_streams"] == 0,
                f"{name}: slots left after the streams: {stats}")
        if name != "ring":
            require(stats["gen_kv_blocks_used"]
                    == stats["gen_kv_blocks_cached"],
                    f"{name}: pages left after the streams (only the prefix "
                    f"cache may hold any): {stats}")
    require(paged_stats["gen_prefix_hits"] > 0, "no prefix-cache hit")
    require(small_stats["gen_preemptions"] > 0,
            f"a pool of {SMALL_POOL_BLOCKS} blocks preempted no stream")

    # the streams against the f32 plain-attention forward on the card
    ref_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, use_flash=False))
    ref_model = convert.from_jax_params(blob, ref_cfg, "cuda:0")
    refs = lm_reference(ref_model, prompts, greedy["tokens"])
    held = [compared_greedy(s, r) for s, r in zip(greedy["tokens"], refs)]
    for other, label in ((paged["binary"]["tokens"], "binary (v3) and JSON"),
                         (ring["tokens"], "ring and paged")):
        for a, b, n in zip(greedy["tokens"], other, held):
            same_until(a, b, n, f"{label} greedy streams")
    srefs = lm_reference(ref_model, prompts, paged["sampled"]["tokens"])
    sheld = [compared_sampled(s, r, p, seed) for s, r, p, seed in zip(
        paged["sampled"]["tokens"], srefs, prompts, seeds)]
    for other, label in ((paged["sampled again"]["tokens"], "two runs'"),
                         (small["tokens"], "preempted and uncontended")):
        for a, b, n in zip(paged["sampled"]["tokens"], other, sheld):
            same_until(a, b, n, f"{label} sampled streams")
    # phase 13 serves this trial again, with a draft and through deaths
    LM_RUN.update(trial=trial, blob=blob, source=source, prompts=prompts,
                  seeds=seeds, greedy=greedy, held=held,
                  sampled=paged["sampled"]["tokens"], sheld=sheld)
    print(f"lm: greedy streams equal the f32 plain-attention argmax for "
          f"{sum(held)} of {STREAMS * GEN_TOKENS} tokens (each stream up to "
          f"its first top-2 gap under {TIE_GAP:g}: {held}), and so do the "
          f"binary and ring streams; sampled streams (temperature "
          f"{SAMPLING['temperature']}, top_p {SAMPLING['top_p']}, seeds "
          f"{seeds}) equal the reference's draws for {sum(sheld)} tokens "
          f"({sheld}), twice and under preemption "
          f"({small_stats['gen_preemptions']} preemptions)", flush=True)
    del ref_model

    # the decode step alone: per call, its kernels, the pool's bytes
    m = clazz(**trial["knobs"])
    m.load_parameters(blob)
    bt, pos = 16, 575
    per_slot = -(-cfg.max_len // bt)
    cache = m.init_paged_kv_cache(STREAMS * per_slot, bt)
    tables = np.arange(STREAMS * per_slot, dtype=np.int32).reshape(
        STREAMS, per_slot)
    ids = np.arange(STREAMS, dtype=np.int32)
    positions = np.full(STREAMS, pos, np.int32)
    step = lambda: m.paged_decode_step(cache, ids, positions,  # noqa: E731
                                       tables)
    call_ms = median_ms(step, reps=20)
    ring_cache = m.init_kv_cache(STREAMS)
    ring_step = lambda: m.decode_step(ring_cache, ids,  # noqa: E731
                                      positions)
    ring_ms = median_ms(ring_step, reps=20)
    weights = sum(p.numel() * p.element_size()
                  for p in m._model.parameters())
    print(f"lm: decode step of {STREAMS} slots at position {pos}: paged "
          f"{call_ms:.2f} ms per call (argmax to the host included), ring "
          f"{ring_ms:.2f} ms; KV pool {lm.paged_pool_bytes(cache) / 1e9:.3f}"
          f" GB ({STREAMS * per_slot} blocks x {bt} tokens), ring "
          f"{lm.paged_pool_bytes(ring_cache) / 1e9:.3f} GB; weights "
          f"{weights / 1e9:.3f} GB f32 (bound "
          f"{weights / HBM_BYTES_PER_S * 1e3:.3f} ms a step); card {card}",
          flush=True)
    print_device_profile(step, "paged decode step (8 slots)", top=6)
    print_device_profile(ring_step, "ring decode step (8 slots)", top=4)
    del m, cache, ring_cache
    return [a + b for a, b in zip(train_counts, serve_counts)]


def text_phase(card: str) -> tuple:
    t0 = time.perf_counter()
    bert_counts = bert_phase(card)
    lm_counts = lm_phase(card)
    print(f"text: phase 8 took {time.perf_counter() - t0:.0f} s", flush=True)
    return bert_counts, lm_counts


# ---------------------------------------------------------------------------
# phase 12: serving control (fused ensemble, admission, the result cache)
# ---------------------------------------------------------------------------

#: what lm_phase hands phase 13: its trial and parameters, prompts and
#: seeds, the greedy and sampled streams and how far each was held
LM_RUN: dict = {}
#: what bert_phase hands phases 12 and 16: its queries, the unfused
#: ensemble's answers to the first 8, the trials' mean of them and each
#: trial's own, and its p50 of 8
BERT_RUN: dict = {}
#: 12a: the fused ensemble's attention: T trials of phase 8's BERT-base
#: serving batch
FUSED_T, FUSED_B = 2, 64
#: 12c: concurrent requests of 8 sentences against an in-flight cap of 2
BURST, BURST_CAP = 16, 2
#: 12c: queries put on the worker's queue ahead of the 429 request, and the
#: request's deadline
BACKLOG_QUERIES, TINY_TIMEOUT_S = 192, 0.001
#: 12c: requests sent one at a time while one is held at a cap of 1
LONE_SHEDS = 5
SERVE_CONTROL_TIMED = 10  # requests of 8 sentences a door, and a cache pass


def fused_k1(card: str) -> dict:
    """12a: K1 under ``torch.func.vmap`` over T stacked trials, on the
    stacked projection's views, against its plain version for each trial;
    one launch a call; timed beside two separate K1 calls and the bound.
    Returns the shape's entry for K1's line."""
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    vmap = torch.func.vmap
    t, b, h, s, dh = FUSED_T, FUSED_B, 12, 128, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bf16 = torch.bfloat16
    x = torch.randn(t, b, s, h * dh, generator=gen, device="cuda").to(bf16)
    ws = [(torch.randn(t, h * dh, h, dh, generator=gen, device="cuda")
           * 0.03).to(bf16) for _ in range(3)]

    def project(xt, wq, wk, wv):
        return [torch.einsum("bsd,dhk->bhsk", xt, w) for w in (wq, wk, wv)]

    with torch.inference_mode():
        # the projection's outputs as the stacked forward holds them
        q, k, v = vmap(project)(x, *ws)
        copies = fa.flash_attention.vmap_copies
        fa.flash_attention.launches = 0
        out = vmap(fa.flash_attention)(q, k, v)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        copied = fa.flash_attention.vmap_copies - copies
        err = max(_out_err(out[i], fa.flash_attention_plain(
            q[i], k[i], v[i]), False)[0] for i in range(t))
        tol = TOL[bf16]
        require(bool(torch.isfinite(out).all()), "fused K1: non-finite")
        require(err <= tol, f"fused K1 off its plain version by {err:.3g} "
                f"(tol {tol:g})")
        require(launches == 1, f"fused K1 launched {launches} times a call")
        fused = lambda: vmap(fa.flash_attention)(q, k, v)  # noqa: E731
        two = lambda: [fa.flash_attention(q[i], k[i], v[i])  # noqa: E731
                       for i in range(t)]
        ms = device_ms(fused)
        two_ms = device_ms(two)
        folded = [z.reshape(t * b, h, s, dh) for z in (q, k, v)]
        plain_ms = device_ms(lambda: fa.flash_attention_plain(*folded),
                             reps=3, inner=3)
        library_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *folded))
    bound = attention_bound("fwd", t * b, h, s, s, dh, False, bf16)
    print(f"serve control: 12a K1 under vmap over T={t} trials (B={b}, "
          f"H={h}, S={s}, Dh={dh}, bf16, the stacked projection's views; "
          f"the fold {'copied ' + str(copied) + ' of q, k, v' if copied else 'a view, no copy'}"
          f"): max_abs_err {err:.3g} (tol {tol:g}) against the plain "
          f"version of each trial, {launches} launch a call; {ms:.4f} ms "
          f"({rate(bound, ms)}), two K1 calls at B={b} {two_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}); card {card}", flush=True)
    return {"shape": [t, b, h, s, dh], "label": "fused ensemble (vmap)",
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "two_calls_ms": two_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "launches_a_call": launches,
            "fold_copies": copied}


def _door_post(url: str, body: dict, token: str) -> tuple:
    """(status, headers, seconds) of one JSON POST, any status."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {token}"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, headers, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, dict(e.headers), e.read()
    return status, headers, time.perf_counter() - t0, raw


def _healthz(host: str, port: int) -> dict:
    with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                timeout=30) as resp:
        return json.loads(resp.read())


def serving_control_phase(card: str) -> tuple:
    """Phase 12 on phase 8a's two trained BERT-base trials: 12a the
    vmapped K1; 12b the job deployed with ``ENSEMBLE_FUSED`` through
    ``Client`` (answers against 8a's unfused ensemble, K1 launched once a
    layer over both trials' rows, p50 through both doors); 12c admission
    on the job's door (a burst past a cap of 2, a deadline it cannot
    meet); 12d the result cache. Returns (K1's shape entry, each kernel's
    launches on this path)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.predictor import result_cache

    t_phase = time.perf_counter()
    shape_entry = fused_k1(card)
    queries = BERT_RUN["queries"]
    kernels = _kernels()
    admin, server, new_client = _stack("text", "text.sqlite3", fresh=False)
    try:
        c = new_client()
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        admin_url = f"http://127.0.0.1:{server.port}/predict/sst2"
        eight = {"queries": queries[:8]}
        # ---- the main path's run (12b, the fused job): counts from 0 ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        with _Env(RAFIKI_PREDICTOR_PORTS="1"):
            inf = c.create_inference_job("sst2",
                                         budget={"ENSEMBLE_FUSED": 1})
        deploy_s = time.perf_counter() - t0
        answers = np.asarray(c.predict("sst2", queries[:8]))
        direct = np.asarray(c.predict_direct("sst2", queries[:8]))
        lat = {"admin": [], "direct": []}
        for _ in range(SERVE_CONTROL_TIMED):
            lat["admin"].append(_door_post(admin_url, eight, token)[2])
            t = time.perf_counter()
            c.predict_direct("sst2", queries[:8])
            lat["direct"].append(time.perf_counter() - t)
        fused_counts = [k.launches for k in kernels]
        # ------------------------------------------------------------------
        stats = c.get_inference_job_stats("sst2")
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == 1,
                f"fused job {inf['status']} with {len(inf['workers'])} "
                "workers")
        (row,) = stats["workers"]
        require(bool(row.get("fused_dispatch")),
                f"fused worker did not fuse: {row}")
        forwards = stats["batches"] + PREDICT_BUCKETS
        expect = [DEPTH * forwards, 0, 0, 0]
        require(fused_counts == expect,
                f"fused launches {fused_counts}, expected {expect} (one K1 "
                f"a layer over both trials' rows)")
        require(answers.shape == (8, 2) and np.isfinite(answers).all(),
                f"fused /predict answered {answers.shape}")
        p50 = {k: statistics.median(v) * 1e3 for k, v in lat.items()}
        BERT_RUN["fused_p50_8"] = p50["admin"]  # phase 14d's int8 beside it
        print(f"serve control: 12b ENSEMBLE_FUSED job RUNNING in "
              f"{deploy_s:.1f} s (1 worker holding {TRIALS} trials on "
              f"{row['chips']}, fused_dispatch {row['fused_dispatch']}); "
              f"K1 launched {fused_counts[0]} times in {forwards} bucketed "
              f"fused forwards ({DEPTH} a forward, not {DEPTH * TRIALS}); "
              f"p50 of 8 sentences: admin door {p50['admin']:.2f} ms, "
              f"predict_direct {p50['direct']:.2f} ms, against 8a's "
              f"unfused admin door {BERT_RUN['p50_8']:.2f} ms; card {card}",
              flush=True)
        print("serve control: 12b the fused answers against 8a's unfused "
              "ensemble: " + prob_check("fused /predict/sst2", answers,
                                        BERT_RUN["batch8"])
              + "; against the trials' own mean: "
              + prob_check("fused /predict/sst2", answers,
                           BERT_RUN["own8"])
              + "; predict_direct: "
              + prob_check("predict_direct", direct, answers), flush=True)

        # ---- 12c admission on the job's own door ----
        for kernel in kernels:
            kernel.launches = 0
        host, port = inf["predictor_host"], inf["predictor_port"]
        door = f"http://{host}:{port}/predict"
        before = _healthz(host, port)["admission"]
        barrier = threading.Barrier(BURST)
        results = [None] * BURST

        def one(i):
            barrier.wait()
            results[i] = _door_post(door, eight, token)

        with _Env(RAFIKI_PREDICT_MAX_INFLIGHT=str(BURST_CAP)):
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(BURST)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            after = _healthz(host, port)["admission"]
        codes = [r[0] for r in results]
        shed = [r[2] for r in results if r[0] == 503]
        for status, _, _, raw in results:
            if status == 200:
                got = np.asarray(json.loads(raw)["data"]["predictions"])
                require(got.shape == (8, 2) and np.isfinite(got).all(),
                        f"admitted request answered {got.shape}")
        delta = {k: after[k] - before[k] for k in
                 ("admitted", "shed_capacity", "shed_deadline")}
        require(set(codes) <= {200, 503} and shed,
                f"burst of {BURST} at a cap of {BURST_CAP}: codes {codes}")
        require(delta["admitted"] == codes.count(200)
                and delta["shed_capacity"] == codes.count(503)
                and sum(delta.values()) == BURST,
                f"admission stats {delta} against codes {codes}")
        # the shed alone: one request held in flight behind a backlog at
        # a cap of 1, then requests one at a time (no burst sharing this
        # process with them)
        (queue,) = admin.broker.get_worker_queues(inf["id"]).values()

        def backlog():
            return [f for i in range(0, BACKLOG_QUERIES, 64)
                    for f in queue.submit_many(
                        queries[i:i + 64], deadline=time.monotonic() + 60)]

        lone = []
        with _Env(RAFIKI_PREDICT_MAX_INFLIGHT="1"):
            futs = backlog()
            holder = threading.Thread(
                target=lambda: _door_post(door, eight, token))
            holder.start()
            deadline = time.monotonic() + 30
            while (_healthz(host, port)["admission"]["inflight"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            for _ in range(LONE_SHEDS):
                status, _, secs, _ = _door_post(door, eight, token)
                if status == 503:
                    lone.append(secs)
            holder.join()
            for f in futs:
                f.result(60)
        require(lone, f"no lone 503 behind a held request at a cap of 1")
        # a deadline the backlog cannot meet: queries on the worker's
        # queue, then one request due in TINY_TIMEOUT_S
        ewma = after["ewma_query_s"]
        got429 = None
        for _ in range(3):
            futs = backlog()
            status, headers, secs, _ = _door_post(
                door, {**eight, "timeout_s": TINY_TIMEOUT_S}, token)
            for f in futs:
                f.result(60)
            if status == 429:
                got429 = (headers, secs)
                break
        require(got429 is not None and "Retry-After" in got429[0],
                f"no 429 with Retry-After for a {TINY_TIMEOUT_S} s deadline "
                f"behind {BACKLOG_QUERIES} queued queries")
        admission_counts = [k.launches for k in kernels]
        print(f"serve control: 12c admission on the job's door: a burst of "
              f"{BURST} requests at RAFIKI_PREDICT_MAX_INFLIGHT="
              f"{BURST_CAP}: {codes.count(200)} answered 200, "
              f"{codes.count(503)} shed 503 in {statistics.median(shed) * 1e3:.2f}"
              f" ms (median, 16 clients in this process), stats {delta} "
              f"(admitted + shed = {BURST}); alone, at a cap of 1 behind a "
              f"held request, {len(lone)} of {LONE_SHEDS} shed 503 in "
              f"{statistics.median(lone) * 1e3:.2f} ms (median); a "
              f"{TINY_TIMEOUT_S} s deadline behind {BACKLOG_QUERIES} queued "
              f"queries (EWMA {ewma * 1e3:.3f} ms a query): 429 with "
              f"Retry-After {got429[0]['Retry-After']} in "
              f"{got429[1] * 1e3:.2f} ms; card {card}", flush=True)

        # ---- 12d the result cache ----
        with _Env(RAFIKI_PREDICT_CACHE="1"):
            cache = result_cache.get_cache()
            sets = [{"queries": queries[8 * (i + 1): 8 * (i + 2)]}
                    for i in range(SERVE_CONTROL_TIMED)]
            for kernel in kernels:
                kernel.launches = 0
            miss, hit, first, second = [], [], [], []
            for body in sets:
                st, _, secs, raw = _door_post(admin_url, body, token)
                require(st == 200, f"cache miss pass answered {st}")
                miss.append(secs)
                first.append(json.loads(raw)["data"]["predictions"])
            miss_counts = [k.launches for k in kernels]
            hits0, misses0 = cache.job_totals(inf["id"])
            for body in sets:
                st, _, secs, raw = _door_post(admin_url, body, token)
                require(st == 200, f"cache hit pass answered {st}")
                hit.append(secs)
                second.append(json.loads(raw)["data"]["predictions"])
            hit_counts = [k.launches for k in kernels]
            hits1, misses1 = cache.job_totals(inf["id"])
        require(hit_counts == miss_counts and miss_counts[0] > 0,
                f"the hit pass launched kernels: {miss_counts} -> "
                f"{hit_counts}")
        require(second == first, "a cached answer differs from the first")
        require(hits1 - hits0 == 8 * SERVE_CONTROL_TIMED
                and misses1 == misses0,
                f"cache hits {hits0} -> {hits1}, misses {misses0} -> "
                f"{misses1}")
        print(f"serve control: 12d RAFIKI_PREDICT_CACHE=1: "
              f"{SERVE_CONTROL_TIMED} requests of 8 new sentences, p50 "
              f"{statistics.median(miss) * 1e3:.2f} ms (misses, K1 "
              f"{miss_counts[0]} launches), the same again p50 "
              f"{statistics.median(hit) * 1e3:.2f} ms ({hits1 - hits0} "
              f"hits, no launch, the same answers); card {card}",
              flush=True)
        c.stop_inference_job("sst2")
    finally:
        server.stop()
        admin.shutdown()
    counts = [a + b + m for a, b, m in zip(fused_counts, admission_counts,
                                           miss_counts)]
    print(f"serve control: phase 12 took {time.perf_counter() - t_phase:.0f}"
          f" s", flush=True)
    return shape_entry, counts


# ---------------------------------------------------------------------------
# phase 13: generation, the rest (speculative decoding, stream continuity)
# ---------------------------------------------------------------------------

#: the draft: TorchGenLM at 2 x 384, 6 heads (Dh 64, one of the kernels'
#: head dims), at LMConfig's vocabulary and context, trained as 8b's
#: target is (LM_STEPS Adam steps on (8, 512) of the pattern)
DRAFT_DEPTH, DRAFT_DIM, DRAFT_HEADS = 2, 384, 6
LM_DRAFT = f"""

class TorchGenLMDraft(TorchGenLM):
    generation_spec = GenerationSpec(eos_token_id=None, max_context=2048)
    arch = {{"vocab": 32000, "depth": {DRAFT_DEPTH}, "heads": {DRAFT_HEADS}}}
    training = (8, 512, {LM_STEPS})

    @staticmethod
    def get_knob_config():
        cfg = dict(TorchGenLM.get_knob_config())
        cfg["lr"] = FixedKnob(1e-3)
        cfg["dim"] = FixedKnob({DRAFT_DIM})
        return cfg
"""
SPEC_K = 4  # RAFIKI_GEN_SPEC_K's default
#: the one card, listed once a replica: 13b-13d deploy two replicas (the
#: default), 13e three, each a worker thread holding the card
REPLICA_INVENTORY = [0, 0, 0]
DRILL_REPLICAS = 3
#: 13e's stall window (RAFIKI_GEN_STREAM_TIMEOUT_S), also how long the door
#: takes to notice a replica's death
DRILL_STALL_S = 2.0


def draft_kernel_checks() -> None:
    """K1, and K1 with the LSE, K2 and K3, against their plain versions at
    the draft's shapes (its evaluate forward and its training step:
    causal, B=8, H=6, S=512, Dh=64, bf16), with phase 2's tolerances."""
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 130)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def qkv(b, h, sq, skv, dh, dtype):
        return [randn(b, h, s, dh, dtype=dtype) for s in (sq, skv, skv)]

    bf16 = torch.bfloat16
    b, h, s, dh = 8, DRAFT_HEADS, 512, DRAFT_DIM // DRAFT_HEADS
    q, k, v = qkv(b, h, s, s, dh, bf16)
    out = fa.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    err, measure = _out_err(out, fa.flash_attention_plain(q, k, v, True),
                            True)
    line = (f"K1 draft causal: B={b} H={h} Sq={s} Skv={s} Dh={dh} "
            f"causal=True bf16: {measure} {err:.3g} (tol {TOL[bf16]:g})")
    require(bool(torch.isfinite(out).all()), f"{line}: non-finite")
    require(err <= TOL[bf16], line)
    print(line, flush=True)
    training_kernels(fa, qkv, randn, cases=[
        ("draft causal", b, h, s, s, dh, True, bf16, 64, 64, True)])


def draft_job(card: str, c, kernels) -> tuple:
    """13a: the draft through ``Client``, a one-trial ``TEXT_GENERATION``
    job of ``TorchGenLMDraft``, and its kernels against their plain
    versions at its shapes. Returns (its trial, its template source, each
    kernel's launches in the job)."""
    source = (TEMPLATES / "torch_gen_lm.py").read_text() + LM_DRAFT
    model = c.create_model("lm-draft", "TEXT_GENERATION", source.encode(),
                           "TorchGenLMDraft")
    require(model["verification"] is not None
            and model["verification"]["ok"]
            and model["verification"]["capabilities"]["generation"],
            f"TorchGenLMDraft upload: {model['verification']}")
    # ---- the main path's run (the draft's train job): counts from zero --
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    c.create_train_job("draft", "TEXT_GENERATION", "pattern://train",
                       "pattern://test",
                       budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1},
                       models=["lm-draft"])
    job = c.wait_until_train_job_stopped("draft", timeout_s=900,
                                         poll_s=0.05)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    # -------------------------------------------------------------------
    require(job["status"] == "STOPPED", f"draft job {job['status']}: "
            f"{job.get('error_reason')}")
    (trial,) = c.get_trials_of_train_job("draft")
    require(trial["status"] == "COMPLETED" and np.isfinite(trial["score"]),
            f"draft trial {trial['status']} {trial['score']}")
    expect = [DRAFT_DEPTH] + [DRAFT_DEPTH * LM_STEPS] * 3
    print(f"spec: draft train job (TorchGenLMDraft {DRAFT_DEPTH} x "
          f"{DRAFT_DIM}, {DRAFT_HEADS} heads, 1 trial, {LM_STEPS} Adam steps "
          f"on (8, 512), causal) STOPPED in {job_s:.1f} s "
          f"(Client.create_train_job to STOPPED); loss after training "
          f"{-trial['score']:.4f} (the target's "
          f"{-LM_RUN['trial']['score']:.4f}); launches K1 {counts[0]}, "
          f"K1-LSE {counts[1]}, K2 {counts[2]}, K3 {counts[3]} (expected "
          f"{expect}); card {card}", flush=True)
    require(counts == expect, f"launches {counts}, expected {expect}")
    draft_kernel_checks()
    return trial, source, counts


def _deploy(c, app: str, budget: dict = None, **env: str) -> tuple:
    """(inference job, deploy seconds) with its own door, its workers
    started under ``env``."""
    t0 = time.perf_counter()
    with _Env(RAFIKI_PREDICTOR_PORTS="1", **env):
        inf = c.create_inference_job(app, budget=budget)
    return inf, time.perf_counter() - t0


def _idle_rows(c, app: str, dead: set = frozenset()) -> dict:
    """The live workers' stats rows by service id, once none holds a
    stream (30 s at most)."""
    deadline = time.monotonic() + 30
    while True:
        rows = {r["service_id"]: r for r in
                c.get_inference_job_stats(app)["workers"]
                if r["service_id"] not in dead}
        if all(r.get("gen_resident_streams", 1) == 0
               for r in rows.values()) or time.monotonic() > deadline:
            return rows
        time.sleep(0.1)


def _spec_counts(rows: dict) -> tuple:
    return tuple(sum(r.get(f"gen_spec_{k}", 0) for r in rows.values())
                 for k in ("proposed", "accepted", "rounds"))


class _VerifyCapture:
    """In place of ``models.lm.paged_verify_step`` while installed: keeps
    the inputs (the pool pages its tables map, copied before the call
    writes them) and outputs of a call with sampled rows, the first with
    ``rows`` live slots (until then, of the one with the most)."""

    def __init__(self, rows: int):
        from rafiki_tpu_torch.models import lm

        self.lm, self.orig, self.got = lm, lm.paged_verify_step, None
        self.rows, self.live = rows, 0
        lm.paged_verify_step = self

    def __call__(self, model, cache, ids, positions, block_tables,
                 draft_probs, sampling):
        tables = np.array(block_tables)
        pool = cache["k"].shape[1]
        live = int((tables < pool).any(1).sum())
        if self.live >= min(self.rows, live) or not (
                np.asarray(sampling["temperature"]) > 0).any():
            return self.orig(model, cache, ids, positions, block_tables,
                             draft_probs, sampling)
        self.live = live
        with torch.inference_mode():
            used = np.unique(tables[tables < pool])
            idx = torch.from_numpy(used).to(cache["k"].device)
            pages = {n: t[:, idx].cpu() for n, t in cache.items()}
            out = self.orig(model, cache, ids, positions, block_tables,
                            draft_probs, sampling)
            self.got = dict(
                pages=pages, used=used, tables=tables, ids=np.array(ids),
                positions=np.array(positions),
                q=torch.as_tensor(draft_probs).float().cpu(),
                sampling={k: np.array(v) for k, v in sampling.items()},
                out=tuple(np.array(torch.as_tensor(o).cpu()) for o in out[:2]))
        return out

    def close(self) -> None:
        self.lm.paged_verify_step = self.orig


def verify_margins(logits, ids, positions, q, sampling) -> np.ndarray:
    """Each row's least distance of a decision a verify made from the
    point where it would flip: a greedy row's top-2 gaps at the positions
    it committed; a sampled row's accept tests |u q(d) - p(d)| up to its
    first rejection and its last draw's uniform from the cumulative
    boundaries of the distribution it drew from."""
    from rafiki_tpu_torch.models import lm

    k = ids.shape[1] - 1
    d = torch.from_numpy(ids[:, 1:].astype(np.int64))
    temp = np.asarray(sampling["temperature"], np.float32)
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    p = lm.modified_dist(logits, temp[:, None],
                         np.asarray(sampling["top_k"])[:, None],
                         np.asarray(sampling["top_p"])[:, None])
    p_d = torch.gather(p[:, :k], -1, d[..., None])[..., 0]
    q_d = torch.gather(q, -1, d[..., None])[..., 0]
    u = torch.from_numpy(lm._uniform_at(sampling["seed"], positions[:, 1:],
                                        lm.ROLE_ACCEPT))
    a = torch.cumprod((u * q_d < p_d).long(), -1).sum(-1)
    test = (u * q_d - p_d).abs().numpy()
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rs = resid.sum(-1, keepdim=True)
    dist = torch.cat([torch.where(rs > 1e-20, resid / rs.clamp_min(1e-20),
                                  p[:, :k]), p[:, k:]], 1)
    x = dist[torch.arange(len(a)), a]
    u_x = torch.from_numpy(lm._uniform_at(
        sampling["seed"], positions[:, 0] + 1 + a.numpy(), lm.ROLE_TARGET))
    draw = (x.cumsum(-1) - u_x[:, None]).abs().min(-1).values.numpy()
    out = []
    for i, ai in enumerate(a.tolist()):
        if temp[i] <= 0:
            out.append(float(gap[i, :ai + 1].min()))
        else:
            out.append(float(min(test[i, :min(ai + 1, k)].min(), draw[i])))
    return np.asarray(out)


def verify_on_cpu(card: str, got: dict) -> None:
    """13c: the captured round's verify on the card against the same call
    on a CPU f32 copy of the target and of the pages it read: accept
    lengths and tokens equal on every row whose decisions clear
    DRAW_MARGIN (a greedy row: TIE_GAP)."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm
    from rafiki_tpu_torch.sdk.model import load_model_class

    clazz = load_model_class(LM_RUN["source"].encode(), "TorchGenLMFull")
    cfg = clazz(**LM_RUN["trial"]["knobs"])._cfg
    model = convert.from_jax_params(LM_RUN["blob"], cfg, "cpu")
    used, tables = got["used"], got["tables"]
    n_used = len(used)
    live = np.isin(tables, used)
    remapped = np.where(live, np.searchsorted(used, tables), n_used)
    rows = [i for i in range(len(tables)) if live[i].any()]
    with torch.inference_mode():
        pages = {n: t.clone() for n, t in got["pages"].items()}
        logits = lm._paged_forward(model, pages, remapped, got["ids"],
                                   got["positions"])
        pages = {n: t.clone() for n, t in got["pages"].items()}
        acc, toks, _ = lm.paged_verify_step(model, pages, got["ids"],
                                            got["positions"], remapped,
                                            got["q"], got["sampling"])
    margins = verify_margins(logits, got["ids"], got["positions"], got["q"],
                             got["sampling"])
    temp = got["sampling"]["temperature"]
    card_acc, card_toks = got["out"]
    held = []
    for i in rows:
        limit = TIE_GAP if temp[i] <= 0 else DRAW_MARGIN
        if margins[i] < limit:
            continue
        require(int(card_acc[i]) == int(acc[i])
                and card_toks[i].tolist() == toks[i].tolist(),
                f"verify row {i}: the card accepted {int(card_acc[i])} "
                f"({card_toks[i].tolist()}), the CPU {int(acc[i])} "
                f"({toks[i].tolist()}); margin {margins[i]:.3g}")
        held.append(i)
    require(held, f"no verify row cleared its margin: {margins[rows]}")
    print(f"spec: one captured sampled round's paged_verify_step "
          f"({len(rows)} slots, k={got['ids'].shape[1] - 1}) on the card "
          f"against a CPU f32 copy: accept lengths "
          f"{[int(card_acc[i]) for i in rows]} and tokens equal on "
          f"{len(held)} of {len(rows)} rows (the others' margins under "
          f"{DRAW_MARGIN:g}: "
          f"{[float(margins[i]) for i in rows if i not in held]}); card "
          f"{card}", flush=True)


def _host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of one call, to its result on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def spec_step_times(card: str, dtrial: dict, dsource: str,
                    dblob: dict) -> None:
    """13b: one draft burst (k steps on the draft's ring) and one verify
    (k+1 positions on the target's pool), 8 slots at position 575: the
    host clock, CUDA events around a call, and the kernels of a call."""
    from rafiki_tpu_torch.models import lm
    from rafiki_tpu_torch.sdk.model import load_model_class

    m = load_model_class(LM_RUN["source"].encode(), "TorchGenLMFull")(
        **LM_RUN["trial"]["knobs"])
    m.load_parameters(LM_RUN["blob"])
    d = load_model_class(dsource.encode(), "TorchGenLMDraft")(
        **dtrial["knobs"])
    d.load_parameters(dblob)
    bt, pos = 16, 575
    per_slot = -(-m._cfg.max_len // bt)
    cache = m.init_paged_kv_cache(STREAMS * per_slot, bt)
    tables = np.arange(STREAMS * per_slot, dtype=np.int32).reshape(
        STREAMS, per_slot)
    ring = d.init_kv_cache(STREAMS)
    ids = np.arange(STREAMS, dtype=np.int32)
    positions = np.full(STREAMS, pos, np.int32)

    def samp(role, temperature=SAMPLING["temperature"]):
        return {"seed": np.arange(1, STREAMS + 1, dtype=np.uint32),
                "temperature": np.full(STREAMS, temperature, np.float32),
                "top_k": np.zeros(STREAMS, np.int32),
                "top_p": np.full(STREAMS, SAMPLING["top_p"], np.float32),
                "role": role}

    burst = lambda: d.decode_steps_sampled(  # noqa: E731
        ring, ids, positions, SPEC_K, samp(lm.ROLE_DRAFT))
    toks, q, _ = burst()
    ids2 = np.concatenate([ids[:, None], toks], 1).astype(np.int32)
    pos2 = positions[:, None] + np.arange(SPEC_K + 1, dtype=np.int32)
    for label, fn in (
            (f"draft burst (k={SPEC_K} chained sampled steps, {STREAMS} "
             f"slots, ring)", burst),
            (f"sampled verify ({SPEC_K + 1} positions, {STREAMS} slots, "
             f"paged)", lambda: m.paged_verify_step(
                 cache, ids2, pos2, tables, q, samp(lm.ROLE_TARGET))),
            (f"greedy verify ({SPEC_K + 1} positions, {STREAMS} slots, "
             f"paged)", lambda: m.paged_verify_step(
                 cache, ids2, pos2, tables, q, samp(lm.ROLE_TARGET, 0.0)))):
        host = _host_ms(fn)
        events = median_ms(fn, reps=20)
        print(f"spec: {label} at position {pos}: {host:.2f} ms a call on "
              f"the host clock, {events:.2f} ms by CUDA events around a "
              f"call; card {card}", flush=True)
        print_device_profile(fn, label, top=6)
    del m, d, cache, ring


def spec_serving(card: str, c, draft_id: str) -> tuple:
    """13b-13d on one deployment of 8b's trial with the draft, two
    replicas: greedy, sampled twice, then greedy with one replica's draft
    failing. Returns the captured verify round."""
    from rafiki_tpu_torch.utils import chaos

    run = LM_RUN
    prompts, seeds = run["prompts"], run["seeds"]
    inf, deploy_s = _deploy(c, "lm", {"GEN_DRAFT_TRIAL": draft_id})
    require(inf["status"] == "RUNNING" and len(inf["workers"]) == 2
            and inf["predictor_port"], f"inference job {inf}")
    capture = _VerifyCapture(STREAMS // 2)
    try:
        greedy = generate_pass(c, "lm", prompts)
        rows = _idle_rows(c, "lm")
        g_counts = _spec_counts(rows)
        sampled = [generate_pass(c, "lm", prompts, seeds=seeds, **SAMPLING)
                   for _ in range(2)]
    finally:
        capture.close()
    rows = _idle_rows(c, "lm")
    s_counts = [a - b for a, b in zip(_spec_counts(rows), g_counts)]
    for sid, r in rows.items():
        require(r.get("gen_spec_on") is True
                and r.get("gen_spec_rounds", 0) > 0
                and "gen_spec_degraded" not in r,
                f"replica {sid} did not speculate: {r}")
    for a, b, n in zip(greedy["tokens"], run["greedy"]["tokens"],
                       run["held"]):
        same_until(a, b, n, "speculative and plain greedy streams")
    require(sampled[0]["tokens"] == sampled[1]["tokens"],
            "two sampled speculative passes differ")
    require(capture.got is not None, "no sampled verify round captured")
    plain = run["greedy"]

    def rate(pas):
        return STREAMS * GEN_TOKENS / pas["seconds"]

    print(f"spec: 8b's trial served with the draft (GEN_DRAFT_TRIAL, k="
          f"{SPEC_K}, 2 replicas on the card, deploy {deploy_s:.1f} s): "
          f"greedy acceptance {g_counts[1]} of {g_counts[0]} proposed "
          f"({g_counts[1] / max(g_counts[0], 1):.3f}) in {g_counts[2]} "
          f"rounds, "
          f"sampled {s_counts[1]} of {s_counts[0]} "
          f"({s_counts[1] / max(s_counts[0], 1):.3f}) in {s_counts[2]}; "
          f"time to first token p50 "
          f"{statistics.median(greedy['ttft']) * 1e3:.1f} ms (8b plain "
          f"{statistics.median(plain['ttft']) * 1e3:.1f}); {rate(greedy):.0f} "
          f"tokens/s greedy (8b plain {rate(plain):.0f}), "
          f"{rate(sampled[0]):.0f} sampled; greedy streams equal 8b's plain "
          f"ones up to their first top-2 gap under {TIE_GAP:g} "
          f"({sum(run['held'])} tokens); the two sampled passes equal; card "
          f"{card}", flush=True)
    vocab = run["blob"]["embed"]["table"].shape[0]
    pattern = [(prompts[0][-1] + 3 * (j + 1)) % vocab for j in range(8)]
    print(f"spec: stream 0's first greedy tokens {greedy['tokens'][0][:8]}, "
          f"the training pattern's continuation {pattern} (what a draft "
          f"that learnt it proposes)", flush=True)
    # 13d: one replica's draft fails its next round
    victim = sorted(rows)[0]
    chaos.install(chaos.parse_rules(
        f"site=generate;action=error;match=draft/{inf['id']}/{victim};"
        "times=1"))
    try:
        faulted = generate_pass(c, "lm", prompts)
    finally:
        chaos.clear()
    rows = _idle_rows(c, "lm")
    require("chaos" in rows[victim].get("gen_spec_degraded", "")
            and rows[victim]["gen_spec_on"] is False,
            f"the failing draft's replica: {rows[victim]}")
    for sid, r in rows.items():
        if sid != victim:
            require(r["gen_spec_on"] is True, f"replica {sid}: {r}")
    for a, b, n in zip(faulted["tokens"], run["greedy"]["tokens"],
                       run["held"]):
        same_until(a, b, n, "greedy streams past a draft fault and plain")
    print(f"spec: a draft fault on replica {victim[:8]} (site=generate, "
          f"action=error): gen_spec_degraded "
          f"{rows[victim]['gen_spec_degraded']!r}, the other replica still "
          f"speculating; all {STREAMS} greedy streams finished with 8b's "
          f"plain tokens ({rate(faulted):.0f} tokens/s); card {card}",
          flush=True)
    c.stop_inference_job("lm")
    return capture.got


def _drill_pass(c, job_id: str, action: str, dead: set) -> tuple:
    """8 sampled streams of 8b's prompts and seeds; once each has its
    first delta, a ``site=worker`` rule with ``action`` fells the live
    replica holding the most. Returns (the streams and, for each, its
    longest wait for a delta after the rule and when that wait ended,
    from the rule; the victim; the streams it held)."""
    from rafiki_tpu_torch.utils import chaos

    prompts, seeds = LM_RUN["prompts"], LM_RUN["seeds"]
    started = threading.Barrier(STREAMS + 1)
    t_rule = {}
    out = {"tokens": [None] * STREAMS, "wait": [(0.0, 0.0)] * STREAMS,
           "ttft": [None] * STREAMS}
    errors = []

    def run(i):
        try:
            toks, last = [], None
            t0 = time.perf_counter()
            for d in c.generate("lm", prompts[i], max_tokens=GEN_TOKENS,
                                timeout_s=300, seed=seeds[i], **SAMPLING):
                now = time.perf_counter()
                if not toks and d["tokens"]:
                    toks += d["tokens"]
                    out["ttft"][i] = now - t0
                    started.wait(120)
                    continue
                if "t" in t_rule and d["tokens"]:
                    # the deltas queued before the rule come first; a
                    # victim's stream then waits out the stall window
                    gap = now - max(last or t_rule["t"], t_rule["t"])
                    if gap > out["wait"][i][0]:
                        out["wait"][i] = (gap, now - t_rule["t"])
                    last = now
                toks += d["tokens"]
            out["tokens"][i] = toks
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"stream {i}: {e!r}")
            started.abort()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(STREAMS)]
    for th in threads:
        th.start()
    victim, held = None, 0
    try:
        started.wait(120)
        rows = {r["service_id"]: r for r in
                c.get_inference_job_stats("lm")["workers"]
                if r["service_id"] not in dead}
        victim = max(sorted(rows), key=lambda s: rows[s]["gen_slots_busy"])
        held = rows[victim]["gen_slots_busy"]
        t_rule["t"] = time.perf_counter()
        chaos.install(chaos.parse_rules(
            f"site=worker;action={action};match={job_id}/{victim};times=1"))
    except threading.BrokenBarrierError:
        pass  # a stream failed before its first delta: reported below
    finally:
        for th in threads:
            th.join(600)
        chaos.clear()
    require(not errors and not any(th.is_alive() for th in threads)
            and victim is not None,
            f"drill pass failed: {errors} (first tokens after "
            f"{[t and round(t, 2) for t in out['ttft']]} s)")
    require(all(len(t) == GEN_TOKENS for t in out["tokens"]),
            f"streams of {[len(t) for t in out['tokens']]} tokens")
    return out, victim, held


def continuity_drills(card: str, admin, c) -> None:
    """13e: 8b's trial at three replicas, no draft, one-shot prefill, a
    2-s stall window; a
    SIGKILL drill (``drop``) on the replica holding the most sampled
    streams, then a clean retirement (``error``) of another: every stream
    finishes with 8b's uninterrupted tokens, and the door's continuity
    counters count the streams each victim held."""
    from rafiki_tpu_torch import config

    saved = config.INFERENCE_WORKER_REPLICAS_PER_TRIAL
    config.INFERENCE_WORKER_REPLICAS_PER_TRIAL = DRILL_REPLICAS
    try:
        # one-shot prefill: a first token, and a resumed stream's first
        # token on a sibling, must land inside the short stall window
        inf, deploy_s = _deploy(c, "lm", RAFIKI_GEN_PREFILL_CHUNK="0")
    finally:
        config.INFERENCE_WORKER_REPLICAS_PER_TRIAL = saved
    require(inf["status"] == "RUNNING"
            and len(inf["workers"]) == DRILL_REPLICAS,
            f"inference job {inf}")
    predictor = admin.services._predictors[inf["id"]]
    dead: set = set()
    with _Env(RAFIKI_GEN_STREAM_TIMEOUT_S=str(DRILL_STALL_S)):
        for drill, action, reason in (("kill", "drop", "worker_death"),
                                      ("retirement", "error", "migrating")):
            before = predictor.gen_continuity_stats()
            out, victim, held = _drill_pass(c, inf["id"], action, dead)
            dead.add(victim)
            after = predictor.gen_continuity_stats()
            resumed = (after[f"resumes_{reason}"]
                       - before[f"resumes_{reason}"])
            require(resumed == held and after["resume_failures"] == 0,
                    f"{drill}: {resumed} streams resumed ({reason}) for "
                    f"{held} held; {after}")
            for a, b, n in zip(out["tokens"], LM_RUN["sampled"],
                               LM_RUN["sheld"]):
                same_until(a, b, n, f"streams through the {drill} and 8b's "
                           "uninterrupted sampled")
            waits = sorted(out["wait"], reverse=True)
            slowest = [(round(g * 1e3), round(t * 1e3))
                       for g, t in waits[:held]]
            print(f"continuity: {drill} ({action}) of replica {victim[:8]} "
                  f"holding {held} of {STREAMS} sampled streams, "
                  f"{len(inf['workers']) - len(dead) + 1} replicas live "
                  f"(deploy {deploy_s:.1f} s, stall window "
                  f"{DRILL_STALL_S:g} s): resumes_{reason} {resumed}, "
                  f"resume_failures {after['resume_failures']}; first tokens "
                  f"after {max(out['ttft']):.2f} s at most; every stream "
                  f"finished with {GEN_TOKENS} tokens, equal to 8b's "
                  f"uninterrupted ones up to their draw margins "
                  f"({sum(LM_RUN['sheld'])} tokens); the client's longest "
                  f"wait for a token after the rule, in the {held} streams "
                  f"that waited longest, and when each resumed token came "
                  f"after the rule: "
                  f"{slowest}"
                  f" ms (the others' longest waits "
                  f"{[round(g * 1e3) for g, _ in waits[held:]]}); card "
                  f"{card}", flush=True)
    print(f"continuity: gen_continuity_stats "
          f"{predictor.gen_continuity_stats()}", flush=True)
    c.stop_inference_job("lm")


def generation_rest_phase(card: str) -> list:
    """Phase 13 on 8b's trained LM and store: 13a the draft's train job;
    13b-13d speculative serving; 13e stream continuity. Returns each
    kernel's launches on this path."""
    from rafiki_tpu_torch.sdk.params import load_params

    t_phase = time.perf_counter()
    kernels = _kernels()
    admin, server, new_client = _stack("lm", "text_lm.sqlite3", fresh=False,
                                       inventory=REPLICA_INVENTORY)
    try:
        c = new_client()
        dtrial, dsource, train_counts = draft_job(card, c, kernels)
        dblob = load_params(c.download_trial_params(dtrial["id"]))
        t_spec = time.perf_counter()
        # ---- the main path's run (serving): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        got = spec_serving(card, new_client(), dtrial["id"])
        t_drill = time.perf_counter()
        continuity_drills(card, admin, new_client())
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
    finally:
        server.stop()
        admin.shutdown()
    require(serve_counts == [0, 0, 0, 0], f"attention kernels launched "
            f"while serving generation: {serve_counts}")
    verify_on_cpu(card, got)
    spec_step_times(card, dtrial, dsource, dblob)
    print(f"generation, the rest: 13a took {t_spec - t_phase:.0f} s, 13b-d "
          f"{t_drill - t_spec:.0f} s, 13e "
          f"{time.perf_counter() - t_drill:.0f} s with the checks; phase 13 "
          f"took {time.perf_counter() - t_phase:.0f} s", flush=True)
    return [a + b for a, b in zip(train_counts, serve_counts)]


# ---------------------------------------------------------------------------
# phase 9: the trial loop (faults, ASHA, deadlines, resume)
# ---------------------------------------------------------------------------

#: 9a: images in the set whose one batch does not fit the card (ViT-B/16's
#: activations at batch 2,048 come to ~190 GB, ~94 MB an image as phase
#: 18's batch-64 child holds; the set itself, 1.23 GB of f32, does fit;
#: 4,096 until phase 18 needed the run's time)
OOM_IMAGES = 2048
#: what a failed trial may leave allocated: a worker thread's first cuBLAS
#: calls allocate its workspaces through the caching allocator
OOM_SLACK_BYTES = 64 << 20
#: 9b: ASHA over 3 trials of 2 epochs (rungs 1, 2 at eta 2); 6 trials
#: until phase 12, 4 epochs until phase 15 and 4 trials until phase 18
#: needed the run's time (PERF.md, section 4)
ASHA_TRIALS, ASHA_EPOCHS, ASHA_ETA = 3, 2, 2
#: 9c: epochs budgeted, and the cap past a trial's first report in epoch
#: times of 9b (report to report: 9b and 9c fit with no per-epoch
#: checkpoint, which 9d drills). The trial's clock starts before its
#: set-up (ViT-B/16's init and the dataset read, seconds on the card), so
#: the cap is 9b's median first report plus 1.5 of its epochs: the stop
#: then falls mid-run, where the first-boundary rule can be seen (2.5
#: until phase 18 needed the run's time)
CAP_EPOCHS, CAP_EPOCHS_OF_9B = 8, 1.5
#: 9c: trials of the job; 2 until phase 14 needed the run's time (PERF.md,
#: section 4): each is stopped by its own clock, so one shows the rule
CAP_TRIALS = 1
#: 9c: the trial's stop check starts its clock after the row's
#: datetime_started (reserve, then the logger and the check are made):
#: an epoch before the stop may read up to this much past the cap
CAP_SLACK_S = 0.25
#: 9d: epochs of the resumed job (3 until phase 15 needed the run's time:
#: the kill lands after the first, so one is left to resume)
RESUME_EPOCHS = 2


def no_checkpoint(source: bytes) -> bytes:
    """A template's ``source`` fitting with no per-epoch checkpoint (a
    ViT-B/16 one is a 1.04 GB write, 3.7 s on the card's disk; BERT-base's
    larger), for a phase whose checks never read one (phase 9 drills
    resumes and checkpoint costs with the template as shipped)."""
    old = b"checkpoint_path=self.checkpoint_path"
    require(source.count(old) == 1, "template edit: its checkpoint path")
    return source.replace(old, b"checkpoint_path=None")


def twin_template(cls: str, learning_rate: str, batch_size: int,
                  epochs: int, checkpoint: bool = True) -> bytes:
    """``templates/torch_vit.py`` renamed ``cls`` with its learning rate,
    batch size and epochs knobs replaced; the architecture stays
    ViT-B/16's. ``checkpoint=False`` fits with no per-epoch checkpoint (a
    1.04 GB write each, 3.7 s on the card's disk), for a drill that is
    not about resuming a trial."""
    source = TEMPLATE.read_text()
    edits = [
        ("class TorchViT(BaseModel):", f"class {cls}(BaseModel):"),
        ('"learning_rate": FloatKnob(1e-5, 1e-3, is_exp=True)',
         f'"learning_rate": {learning_rate}'),
        ('"batch_size": CategoricalKnob([64, 128])',
         f'"batch_size": FixedKnob({batch_size})'),
        ('"epochs": FixedKnob(1)', f'"epochs": FixedKnob({epochs})')]
    for old, new in edits:
        require(source.count(old) == 1, f"template edit {old!r}")
        source = source.replace(old, new)
    return source.encode() if checkpoint else no_checkpoint(source.encode())


def _loop_stack(store: str, params: Path):
    """An admin (this process's placement, or the one the environment
    selects) with its door and a logged-in Client."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database

    for path in WORK.glob(store + "*"):
        path.unlink()
    admin = Admin(db=Database(str(WORK / store)), params_dir=str(params))
    server = AdminServer(admin).start()
    c = Client("127.0.0.1", server.port, timeout_s=900)
    c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
    return admin, server, c


class _Env:
    """Settings for a drill, restored after it."""

    def __init__(self, **settings: str):
        self.settings = settings

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.settings}
        os.environ.update(self.settings)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _epoch_records(c, trial_id: str) -> list:
    """The trial's per-epoch reports (``loss``, ``epoch``, ``epoch_time``,
    the log's ``time``), in order."""
    return [m for m in c.get_trial_logs(trial_id)["metrics"] if "loss" in m]


def _trial_line(drill: str, t: dict, epochs: int) -> None:
    score = "none" if t["score"] is None else f"{t['score']:.4f}"
    print(f"loop: {drill} trial {t['id'][:8]} {t['status']}: {epochs} "
          f"epochs, attempt {t['attempt']}, kind {t['fault_kind']}, score "
          f"{score}, learning_rate {t['knobs']['learning_rate']:.3g}",
          flush=True)


def checkpoint_cost(card: str) -> None:
    """One ViT-B/16 + AdamW checkpoint write and its restore into a fresh
    model and optimizer, timed directly (a synchronize on each side)."""
    from rafiki_tpu_torch.convert import from_jax_params
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    cfg = vit.vit_b16()
    tree = vit.init(np.random.default_rng(0), cfg)
    trainer = DataParallelTrainer(
        softmax_classifier_loss(lambda m, x: m(x)),
        tunable_optimizer(torch.optim.AdamW, lr=1e-4), device="cuda:0")
    model, opt = trainer.init(
        lambda rng: from_jax_params(tree, cfg, "cuda:0", train=True))
    rng = np.random.default_rng(SEED + 90)
    batch = (torch.from_numpy(rng.random((8, 224, 224, 3),
                                         dtype=np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, 1000, 8).astype(
                 np.int32)).cuda())
    trainer.train_step(model, opt, batch, None)  # AdamW's moments exist
    path = WORK / "checkpoint_cost.ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._save_checkpoint(str(path), model, opt, 1)
    write_s = time.perf_counter() - t0
    size = path.stat().st_size
    model2, opt2 = trainer.init(
        lambda rng: from_jax_params(tree, cfg, "cuda:0", train=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = trainer._restore_checkpoint(str(path), model2, opt2)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    require(epoch == 1, f"restored epoch {epoch}")
    moments = [v for st in opt2.state.values() for k, v in st.items()
               if k != "step"]
    require(moments and all(v.device.type == "cuda" for v in moments),
            "the restored AdamW state is not on the card")
    for (name, a), b in zip(model.named_parameters(), model2.parameters()):
        require(torch.equal(a, b), f"restored {name} differs")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"loop: one ViT-B/16 + AdamW checkpoint ({n_params} parameters, "
          f"two f32 moments each): {size} bytes ({size / 1e9:.3f} GB) "
          f"written in {write_s:.2f} s ({size / write_s / 1e9:.2f} GB/s: "
          f"to the host, npz, CRC32, fsync, rename), restored onto the "
          f"card in {read_s:.2f} s ({size / read_s / 1e9:.2f} GB/s); card "
          f"{card}", flush=True)
    path.unlink()
    del model, opt, model2, opt2, moments, batch
    torch.cuda.empty_cache()


def oom_drill(card: str) -> list:
    """9a: a job whose every trial raises the allocator's own
    OutOfMemoryError. Returns the kernels' launches in it."""
    from rafiki_tpu_torch.worker import faults

    rng = np.random.default_rng(SEED + 91)
    t0 = time.perf_counter()
    patterns = rng.random((CLASSES, 224, 224, 3), dtype=np.float32)
    x, y = make_dataset(rng, TEST_IMAGES, patterns)
    uris = {"train": str(WORK / "oom_train.npz"),
            "test": str(WORK / "oom_test.npz")}
    np.savez(uris["train"], x=np.tile(x, (OOM_IMAGES // len(x), 1, 1, 1)),
             y=np.tile(y, OOM_IMAGES // len(y)))
    np.savez(uris["test"], x=x, y=y)
    del x, y
    print(f"loop: 9a dataset of {OOM_IMAGES} images (224x224x3 f32, "
          f"{Path(uris['train']).stat().st_size} bytes, np.savez) written "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = _kernels()
    with _Env(RAFIKI_TRIAL_QUARANTINE_K="2", RAFIKI_TRIAL_FAULT_LIMIT="3"):
        admin, server, c = _loop_stack("loop_oom.sqlite3",
                                       WORK / "loop_params")
        # the session's infeasible count as each penalty lands (the job's
        # teardown deletes the session)
        counted = []
        penalize = admin.advisor_store.feedback_infeasible

        def recorded(*args, **kw):
            counted.append(penalize(*args, **kw))
            return counted[-1]

        admin.advisor_store.feedback_infeasible = recorded
        try:
            c.create_model("vit-oom", "IMAGE_CLASSIFICATION", twin_template(
                "OomViT", "FixedKnob(1e-4)", OOM_IMAGES, 1), "OomViT")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(0)
            for kernel in kernels:
                kernel.launches = 0

            # ---- the main path's run (9a) ----
            t0 = time.perf_counter()
            c.create_train_job("oom", "IMAGE_CLASSIFICATION", uris["train"],
                               uris["test"], budget={"MODEL_TRIAL_COUNT": 10,
                                                     "CHIP_COUNT": 1})
            job = c.wait_until_train_job_stopped("oom", timeout_s=600,
                                                 poll_s=0.05)
            fail_s = time.perf_counter() - t0
            # -----------------------------------
            counts = [k.launches for k in kernels]
            row = admin.db.get_train_job(job["id"])
            (sub,) = admin.db.get_sub_train_jobs_of_train_job(job["id"])
            (worker,) = admin.db.get_workers_of_train_job(job["id"])
            deadline = time.monotonic() + 120
            while admin.db.get_service(worker["service_id"])["status"] not in (
                    "STOPPED", "ERRORED"):
                require(time.monotonic() < deadline,
                        "9a: the job's worker was not stopped")
                time.sleep(0.05)
            service = admin.db.get_service(worker["service_id"])["status"]
            trials = sorted(admin.db.get_trials_of_train_job(job["id"]),
                            key=lambda t: t["datetime_started"])
            stats = faults.training_stats().get(sub["id"], {})
        finally:
            server.stop()
            admin.shutdown()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(0)
    for t in trials:
        _trial_line("9a", t, 0)
    require([(t["status"], t["fault_kind"]) for t in trials]
            == [("ERRORED", "USER")] * 3,
            f"9a trials {[(t['status'], t['fault_kind']) for t in trials]}")
    require(all("OutOfMemoryError" in t["fault_detail"]
                and "CUDA out of memory" in t["fault_detail"]
                for t in trials), "9a: a trial's detail is not the "
            f"allocator's OOM: {trials[0]['fault_detail'][:500]}")
    infeasible = max(counted, default=0)
    require(infeasible >= 1 and len(counted) >= 3,
            f"9a: the advisor's infeasible counts {counted}")
    require(stats.get("quarantined") == ["u:"]
            and stats.get("reproposals", 0) >= 1,
            f"9a: quarantine {stats}")
    require((row["status"], row["fault_kind"]) == ("ERRORED", "USER")
            and "RAFIKI_TRIAL_FAULT_LIMIT=3" in (row["error_reason"] or ""),
            f"9a: job {row['status']} {row['fault_kind']}: "
            f"{row['error_reason']}")
    require(after - before <= OOM_SLACK_BYTES,
            f"9a: {after - before} bytes still allocated after the job")
    require(counts[0] == counts[2] == counts[3] == 0,
            f"9a: launches {counts} (no evaluate, no backward)")
    print(f"loop: 9a the allocator's OutOfMemoryError in each of "
          f"{len(trials)} trials (batch {OOM_IMAGES}), each ERRORED USER "
          f"with its detail; the signature quarantined after 2 "
          f"({stats['reproposals']} re-proposals before the third); the "
          f"advisor's infeasible count 0 -> {infeasible} over {len(counted)} "
          f"penalties (one cell: every knob is fixed); the job ERRORED "
          f"({row['error_reason'][:80]}...) in {fail_s:.1f} s from "
          f"Client.create_train_job, its worker {service}; "
          f"memory_allocated {before} -> {after} bytes "
          f"({(after - before) / 2**20:+.1f} MiB); K1-LSE launched "
          f"{counts[1]} times before the OOMs; card {card}", flush=True)
    return counts


def asha_drill(card: str, uris: dict) -> tuple:
    """9b: ASHA on an ASHA_TRIALS-trial job with one chaos fault. Returns (the
    kernels' launches, the median epoch-plus-checkpoint seconds, the
    median seconds from a trial's start to its first report)."""
    from rafiki_tpu_torch.advisor.asha import AshaScheduler

    kernels = _kernels()
    with _Env(RAFIKI_CHAOS="site=trial;action=error;times=1",
              RAFIKI_TRIAL_RETRY_BACKOFF_S="0.05"):
        admin, server, c = _loop_stack("loop_asha.sqlite3",
                                       WORK / "loop_params")
        verdicts = []
        report = admin.advisor_store.report_rung

        def recorded(advisor_id, trial_id, resource, value, **kw):
            keep = report(advisor_id, trial_id, resource, value, **kw)
            verdicts.append((trial_id, resource, value, keep))
            return keep

        admin.advisor_store.report_rung = recorded
        try:
            # the range reaches far below a useful rate: the GP's first
            # three draws are uniform (numpy's default_rng(0): u = 0.637,
            # 0.270, 0.041 of the log range), so 1.5e-3, 2.2e-5 and
            # 1.6e-6; the last two barely move ViT-B/16's loss in 8 steps,
            # which is not competitive at rung 1 against the first
            c.create_model("vit-asha", "IMAGE_CLASSIFICATION", twin_template(
                "AshaViT", "FloatKnob(1e-6, 1e-1, is_exp=True)", 64,
                ASHA_EPOCHS, checkpoint=False), "AshaViT")
            for kernel in kernels:
                kernel.launches = 0

            # ---- the main path's run (9b) ----
            t0 = time.perf_counter()
            c.create_train_job("asha", "IMAGE_CLASSIFICATION", uris["train"],
                               uris["test"], budget={
                                   "MODEL_TRIAL_COUNT": ASHA_TRIALS,
                                   "CHIP_COUNT": 1, "EARLY_STOP": 1,
                                   "ASHA_MIN_EPOCHS": 1,
                                   "ASHA_ETA": ASHA_ETA})
            job = c.wait_until_train_job_stopped("asha", timeout_s=900,
                                                 poll_s=0.05)
            torch.cuda.synchronize()
            job_s = time.perf_counter() - t0
            # -----------------------------------
            counts = [k.launches for k in kernels]
            trials = sorted(admin.db.get_trials_of_train_job(job["id"]),
                            key=lambda t: t["datetime_started"])
            reports = {t["id"]: _epoch_records(c, t["id"]) for t in trials}
            breakdowns = {t["id"]: c.get_trial_logs(t["id"])["metrics"]
                          for t in trials}
        finally:
            server.stop()
            admin.shutdown()
    require(job["status"] == "STOPPED", f"9b job {job['status']}")
    require(len(trials) == ASHA_TRIALS
            and all(t["status"] == "COMPLETED" and np.isfinite(t["score"])
                    for t in trials),
            f"9b trials {[(t['status'], t['score']) for t in trials]}")
    require([(t["attempt"], t["fault_kind"]) for t in trials]
            == [(1, "INFRA")] + [(0, None)] * (ASHA_TRIALS - 1),
            f"9b attempts {[(t['attempt'], t['fault_kind']) for t in trials]}")
    # the verdicts the system gave, against the port's scheduler replayed
    # on the logged reports in their order
    replay = AshaScheduler(min_resource=1, eta=ASHA_ETA)
    logged = [(t["id"], int(m["epoch"]) + 1, m["loss"],
               replay.report(t["id"], int(m["epoch"]) + 1, m["loss"]))
              for t in trials for m in reports[t["id"]]]
    require(logged == verdicts, f"9b verdicts {verdicts} != replay {logged}")
    trained = {}
    for t in trials:
        mine = [keep for tid, _, _, keep in verdicts if tid == t["id"]]
        stop = mine.index(False) + 1 if False in mine else ASHA_EPOCHS
        trained[t["id"]] = len(reports[t["id"]])
        require(trained[t["id"]] == min(stop, ASHA_EPOCHS),
                f"9b trial {t['id'][:8]} trained {trained[t['id']]} epochs, "
                f"its verdicts {mine}")
        _trial_line("9b", t, trained[t["id"]])
    require(min(trained.values()) < ASHA_EPOCHS,
            f"9b: no trial stopped early ({trained})")
    steps = sum(trained.values()) * (TRAIN_IMAGES // 64)
    expect = [DEPTH * ASHA_TRIALS] + [DEPTH * steps] * 3
    require(counts == expect, f"9b launches {counts}, expected {expect}")
    gaps = [b["time"] - a["time"] for r in reports.values()
            for a, b in zip(r, r[1:])]
    steps_s = [m["epoch_time"] for r in reports.values() for m in r]
    epoch_ckpt = statistics.median(gaps)
    first = statistics.median(reports[t["id"]][0]["time"]
                              - t["datetime_started"] for t in trials[1:])
    # after a trial's last report: its fit's last checkpoint (written at
    # the end or at the stop, then deleted with the trial), evaluate and
    # the params write, from the worker's phase breakdown (logged last)
    tails = []
    for t in trials:
        (phases,) = [m for m in breakdowns[t["id"]] if "trace_train_s" in m]
        train_end = (phases["time"] - phases["trace_evaluate_s"]
                     - phases["trace_persist_params_s"])
        tails.append((train_end - reports[t["id"]][-1]["time"],
                      phases["trace_evaluate_s"],
                      phases["trace_persist_params_s"]))
    tail = [statistics.median(x) for x in zip(*tails)]
    rungs = ", ".join(str(ASHA_ETA ** i) for i in range(
        ASHA_EPOCHS.bit_length()) if ASHA_ETA ** i <= ASHA_EPOCHS)
    print(f"loop: 9b ASHA (eta {ASHA_ETA}, rungs {rungs}): "
          f"{sum(trained.values())} epochs trained of "
          f"{ASHA_TRIALS * ASHA_EPOCHS} budgeted ({sorted(trained.values())}"
          f"), every one of {len(verdicts)} verdicts equal to "
          f"AshaScheduler's replay of the logged losses; the chaos fault "
          f"absorbed by trial 1 at attempt 1 in its own row; job "
          f"{job_s:.1f} s; an epoch's steps {statistics.median(steps_s):.3f}"
          f" s (epoch_time, median of {len(steps_s)}), report to report "
          f"{epoch_ckpt:.3f} s (median of {len(gaps)}; no checkpoint), a "
          f"trial's start to its first report {first:.3f} "
          f"s (median, the chaos-retried trial aside); after the last "
          f"report, the rest of its fit {tail[0]:.3f} s, evaluate "
          f"{tail[1]:.3f} s, the params write {tail[2]:.3f} s (medians); "
          f"launches {counts} (= "
          f"{DEPTH} x {steps} steps, {DEPTH} x {ASHA_TRIALS} evaluates); "
          f"card {card}", flush=True)
    return counts, epoch_ckpt, first


def cap_drill(card: str, uris: dict, epoch_ckpt_s: float,
              first_s: float) -> list:
    """9c: ``TRIAL_TIMEOUT_S`` at 9b's first report plus 1.5 of its epoch
    times stops an 8-epoch trial at the first epoch boundary past it."""
    kernels = _kernels()
    cap = round(first_s + CAP_EPOCHS_OF_9B * epoch_ckpt_s, 3)
    admin, server, c = _loop_stack("loop_cap.sqlite3", WORK / "loop_params")
    try:
        c.create_model("vit-cap", "IMAGE_CLASSIFICATION", twin_template(
            "CapViT", "FloatKnob(1e-5, 1e-3, is_exp=True)", 64, CAP_EPOCHS,
            checkpoint=False),
            "CapViT")
        for kernel in kernels:
            kernel.launches = 0

        # ---- the main path's run (9c) ----
        t0 = time.perf_counter()
        c.create_train_job("cap", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={
                               "MODEL_TRIAL_COUNT": CAP_TRIALS,
                               "CHIP_COUNT": 1, "TRIAL_TIMEOUT_S": cap})
        job = c.wait_until_train_job_stopped("cap", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        # -----------------------------------
        counts = [k.launches for k in kernels]
        trials = sorted(admin.db.get_trials_of_train_job(job["id"]),
                        key=lambda t: t["datetime_started"])
        reports = {t["id"]: _epoch_records(c, t["id"]) for t in trials}
    finally:
        server.stop()
        admin.shutdown()
    require(job["status"] == "STOPPED" and len(trials) == CAP_TRIALS
            and all(t["status"] == "COMPLETED" and np.isfinite(t["score"])
                    for t in trials),
            f"9c job {job['status']}, trials "
            f"{[(t['status'], t['score']) for t in trials]}")
    epochs = 0
    for t in trials:
        r = reports[t["id"]]
        at = [m["time"] - t["datetime_started"] for m in r]
        require(0 < len(r) < CAP_EPOCHS, f"9c trial {t['id'][:8]} trained "
                f"{len(r)} epochs of {CAP_EPOCHS}")
        require(at[-1] > cap and all(a <= cap + CAP_SLACK_S
                                     for a in at[:-1]),
                f"9c trial {t['id'][:8]}: reports at {at} s, cap {cap} s")
        epochs += len(r)
        _trial_line("9c", t, len(r))
        print(f"loop: 9c trial {t['id'][:8]} reports at "
              + ", ".join(f"{a:.2f}" for a in at)
              + f" s from its start (epoch_time "
              + ", ".join(f"{m['epoch_time']:.2f}" for m in r)
              + f" s); stopped at the first past the cap of {cap} s",
              flush=True)
    steps = epochs * (TRAIN_IMAGES // 64)
    expect = [DEPTH * CAP_TRIALS] + [DEPTH * steps] * 3
    require(counts == expect, f"9c launches {counts}, expected {expect}")
    print(f"loop: 9c TRIAL_TIMEOUT_S={cap} (9b's first report at "
          f"{first_s:.3f} s + {CAP_EPOCHS_OF_9B} x its {epoch_ckpt_s:.3f} s "
          f"epoch): {CAP_TRIALS} trial(s) COMPLETED after "
          f"{epochs} epochs of {CAP_TRIALS * CAP_EPOCHS} budgeted; job "
          f"{job_s:.1f} s; card {card}", flush=True)
    return counts


def resume_drill(card: str, uris: dict,
                 entered: threading.Event = None) -> list:
    """9d: the train child SIGKILLed mid-trial under process placement,
    restarted under its service id, resumes the trial from its checkpoint.
    Returns the launches of the restarted child (the killed one's are
    lost with it). ``entered`` is set once its settings are in this
    process's environment (a phase beside it copies the environment
    after that, never while it changes)."""
    from rafiki_tpu_torch.worker import bootstrap

    logs = WORK / "loop_logs"
    params = WORK / "loop_proc_params"
    for path in [*logs.glob("*"), *params.glob("*")]:
        path.unlink()
    with _Env(RAFIKI_PLACEMENT="process", RAFIKI_LOGS_DIR=str(logs),
              RAFIKI_PARAMS_DIR=str(params)):
        if entered is not None:
            entered.set()
        admin, server, c = _loop_stack("loop_proc.sqlite3", params)
        replays = []
        replay = admin.advisor_store.replay_feedback

        def recorded(*args, **kw):
            replays.append(replay(*args, **kw))
            return replays[-1]

        admin.advisor_store.replay_feedback = recorded
        try:
            c.create_model("vit-resume", "IMAGE_CLASSIFICATION",
                           twin_template("ResumeViT",
                                         "FloatKnob(1e-5, 1e-3, is_exp=True)",
                                         64, RESUME_EPOCHS), "ResumeViT")

            # ---- the main path's run (9d, in children) ----
            t0 = time.perf_counter()
            c.create_train_job("resume", "IMAGE_CLASSIFICATION",
                               uris["train"], uris["test"],
                               budget={"MODEL_TRIAL_COUNT": 2,
                                       "CHIP_COUNT": 1})
            job_id = c.get_train_job("resume")["id"]
            # the kill lands in the second trial: the first is COMPLETED,
            # so the restarted child's replay meets a session that holds
            # its observation (a kill in the first would leave nothing to
            # replay, and the guard would never be asked)
            deadline = time.monotonic() + 600
            while True:
                trials = sorted(admin.db.get_trials_of_train_job(job_id),
                                key=lambda t: t["datetime_started"])
                if (len(trials) == 2 and (params / f"{trials[1]['id']}.ckpt")
                        .exists()):
                    break
                require(time.monotonic() < deadline,
                        "9d: no checkpoint of the second trial")
                time.sleep(0.02)
            victim = trials[1]
            (sid, records), = child_records(logs, "startup").items()
            killed = records[0]["pid"]
            os.kill(killed, signal.SIGKILL)
            t_kill = time.time()
            job = c.wait_until_train_job_stopped("resume", timeout_s=900,
                                                 poll_s=0.05)
            job_s = time.perf_counter() - t0
            # -------------------------------------------------
            trials = sorted(admin.db.get_trials_of_train_job(job_id),
                            key=lambda t: t["datetime_started"])
            reports = {t["id"]: _epoch_records(c, t["id"]) for t in trials}
        finally:
            server.stop()
            admin.shutdown()
    require(job["status"] == "STOPPED", f"9d job {job['status']}")
    started = child_records(logs, "startup")[sid]
    require(len(started) == 2 and started[0]["pid"] == killed
            and started[1]["pid"] != killed,
            f"9d: startup lines {started}")
    log = (logs / f"service-{sid}.log").read_text()
    m = re.search(r"resuming fit from \S+" + victim["id"]
                  + r"\.ckpt at epoch (\d+)", log)
    require(m is not None and int(m.group(1)) >= 1,
            "9d: the restarted child did not resume from the checkpoint")
    resumed_at = int(m.group(1))
    require(len(trials) == 2 and [t["status"] for t in trials]
            == ["COMPLETED"] * 2 and all(np.isfinite(t["score"])
                                         for t in trials),
            f"9d trials {[(t['status'], t['score']) for t in trials]}")
    again = next(t for t in trials if t["id"] == victim["id"])
    require(again["knobs"] == victim["knobs"]
            and again["worker_id"] == victim["worker_id"] == sid,
            "9d: the resumed trial's knobs or worker changed")
    require(replays == [False], f"9d: replay_feedback returned {replays}")
    left = list(params.glob("*.ckpt*"))
    require(not left, f"9d: checkpoints left {left}")
    require(not _alive(killed) and not _alive(started[1]["pid"]),
            "9d: a child outlived the job")
    (exit_line,) = child_records(logs, "kernel launches")[sid]
    counts = [exit_line[name] for name in bootstrap.KERNELS]
    steps = (RESUME_EPOCHS - resumed_at) * (TRAIN_IMAGES // 64)
    expect = [DEPTH] + [DEPTH * steps] * 3
    require(counts == expect, f"9d: the restarted child launched {counts}, "
            f"expected {expect} (one evaluate, {steps} steps)")
    epochs = [len(reports[t["id"]]) for t in trials]
    for t, n in zip(trials, epochs):
        _trial_line("9d", t, n)
    print(f"loop: 9d the train child (pid {killed}) SIGKILLed once trial "
          f"{victim['id'][:8]}'s checkpoint existed; started again under "
          f"service {sid[:8]} as pid {started[1]['pid']}: "
          f"{started[1]['t_start'] - t_kill:.2f} s kill to the new "
          f"process, {started[1]['t_ready'] - t_kill:.2f} s to RUNNING; it "
          f"resumed the trial at epoch {resumed_at} of {RESUME_EPOCHS} under "
          f"its id and knobs (epochs logged {epochs}); the admin's session "
          f"survived (replay_feedback returned False); 2 trials, no "
          f"checkpoint left; job {job_s:.1f} s; the restarted child's "
          f"launches {counts}; card {card}", flush=True)
    return counts


def timed_resume_drill(card: str, uris: dict,
                       entered: threading.Event = None) -> list:
    t = time.perf_counter()
    counts = resume_drill(card, uris, entered)
    print(f"loop: 9d took {time.perf_counter() - t:.1f} s", flush=True)
    return counts


def trial_loop_phase(card: str, uris: dict, resume: bool = True) -> list:
    """Phase 9; each kernel's launches on its paths, summed. Without
    ``resume``, 9d is left to the caller (``main`` runs it beside phases
    18 and 19)."""
    t0 = time.perf_counter()
    checkpoint_cost(card)
    drills = {}
    t = time.perf_counter()
    drills["9a"] = oom_drill(card)
    print(f"loop: 9a took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    drills["9b"], epoch_ckpt, first = asha_drill(card, uris)
    print(f"loop: 9b took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    drills["9c"] = cap_drill(card, uris, epoch_ckpt, first)
    print(f"loop: 9c took {time.perf_counter() - t:.1f} s", flush=True)
    if resume:
        drills["9d"] = timed_resume_drill(card, uris)
    totals = [sum(c[i] for c in drills.values()) for i in range(4)]
    print(f"loop: launches by drill {json.dumps(drills)}; phase 9 took "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 10: several cards
# ---------------------------------------------------------------------------

MAX_CARDS = 4
PER_CARD = 64         # PERF.md's batch a card, at every world size
STEP_REPS = 10        # timed steps a rank
RESNET_PER_CARD = 128  # phase 7's ResNet-50 batch, a card
ALLREDUCE_REPS = 7
CARDS_TIMED = 5       # /predict requests of each size on the job's door
CARDS_TEST_IMAGES = 128
# n cards against one, same weights, same global batch: the same kernels
# on the same rows, but each bf16 product over a quarter of the rows may
# round otherwise and the gradients are summed in another order, so the
# loss within 1e-3 relative, each leaf's update (SGD at lr 1: minus the
# gradient) within phase 3's step tolerance (GRAD_RTOL, QK_GRAD_RTOL)
CARDS_LOSS_RTOL = 1e-3
# a served answer on n cards against the same trial on one card: argmax
# equal unless the reference's top two are within this of each other, and
# every probability within it
CARDS_PROB_ATOL = 1e-3


class _Fd2:
    """File descriptor 2 sent to ``path`` while open: the followers a
    thread-placed worker spawns inherit it, and write their ``startup``
    and ``kernel launches`` lines there."""

    def __init__(self, path: Path):
        self.path = path

    def __enter__(self):
        sys.stderr.flush()
        self.saved = os.dup(2)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        os.dup2(fd, 2)
        os.close(fd)

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self.saved, 2)
        os.close(self.saved)


def rank_records(path: Path, kind: str) -> dict:
    """{pid: JSON of its ``kind`` line} from the followers' lines."""
    return {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        kind + r" \(pid (\d+)\): (\{.*\})", path.read_text())}


def rank_kernel_checks(seed: int, batch: int) -> dict:
    """Rank side: K1, K1-LSE, K2 and K3 on this rank's card against their
    plain versions at the training shape (B=``batch``, H=12, S=196,
    Dh=64, bf16): each error, with its tolerance (phase 2's)."""
    from rafiki_tpu_torch.device import default_device

    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    dev = default_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(batch, 12, 196, 64, generator=gen,
                                 device=dev, dtype=torch.bfloat16)
                     for _ in range(4))
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v)
    o, lse, o32 = fa.flash_attention_lse(q, k, v)
    r_out, r_lse, r_o32 = fa.flash_attention_plain(q, k, v,
                                                   return_lse=True)
    delta = fa._delta(r_o32, dout)
    dq, _ = fa.flash_attention_dq(q, k, v, dout, r_lse, r_o32)
    dk, dv = fa.flash_attention_dkv(q, k, v, dout, r_lse, delta)
    torch.cuda.synchronize(dev)
    r_dq = fa.flash_attention_dq_plain(q, k, v, dout, r_lse, delta)
    r_dk, r_dv = fa.flash_attention_dkv_plain(q, k, v, dout, r_lse, delta)
    bf16 = torch.bfloat16
    errs = {"K1": (float((out.float() - r_out.float()).abs().max()),
                   TOL[bf16]),
            "K1-LSE out": (max(float((o.float() - r_out.float()).abs().max()),
                               float((o32 - r_o32.float()).abs().max())),
                           TOL[bf16]),
            "K1-LSE lse": (float((lse - r_lse).abs().max()), LSE_TOL[bf16]),
            "K2 dq": (_rel_err(dq, r_dq), TOL[bf16]),
            "K3 dk": (_rel_err(dk, r_dk), TOL[bf16]),
            "K3 dv": (_rel_err(dv, r_dv), TOL[bf16])}
    return {"device": str(dev), "errs": errs}


def rank_step(seed: int, per_card: int, reps: int,
              profile: bool = False) -> dict:
    """Rank side: one ViT-B/16 step (SGD at lr 1) over a fixed global
    batch of ``per_card`` images a rank, from rank 0's weights, with each
    kernel's launches in it and a checksum of the weights after it, then
    ``reps`` steps timed per call (host clock to a synchronise) and on
    the card (CUDA events around the queued steps). Rank 0 first takes
    the same step on one card over the whole global batch, and times
    steps of ``per_card`` there, the others waiting in the group. With
    ``profile``, rank 0 prints where one more step's time goes."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.parallel import ranks
    from rafiki_tpu_torch.sdk import torch_backend as tb

    group = ranks.current_group()
    n = group.size
    cfg = vit.vit_b16()
    tree = vit.init(np.random.default_rng(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    x = rng.random((per_card * n, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, cfg.num_classes, per_card * n)
    trainer = tb.DataParallelTrainer(
        tb.softmax_classifier_loss(lambda m, xb: m(xb)),
        tb.tunable_optimizer(torch.optim.SGD, lr=1.0))
    dev = trainer.device

    def init(rng):
        return convert.from_jax_params(tree, cfg, dev, train=True)

    def batch(rows):
        return (torch.from_numpy(x[rows]).to(dev),
                torch.from_numpy(y[rows]).to(dev))

    def step(model, opt, b):
        before = [p.detach().clone() for p in model.parameters()]
        loss = trainer.train_step(model, opt, b)
        return loss, {k: (p.detach() - p0).double() for (k, p), p0 in
                      zip(model.named_parameters(), before)}

    def timed(model, opt, b):
        for _ in range(2):
            trainer.train_step(model, opt, b)
        torch.cuda.synchronize(dev)
        calls = []
        for _ in range(reps):
            t = time.perf_counter()
            trainer.train_step(model, opt, b)
            torch.cuda.synchronize(dev)
            calls.append((time.perf_counter() - t) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            trainer.train_step(model, opt, b)
        end.record()
        torch.cuda.synchronize(dev)
        return statistics.median(calls), start.elapsed_time(end) / reps

    out = {"rank": group.rank, "device": str(dev)}
    if group.rank == 0:
        ranks.set_group(None)  # one card, no group
        try:
            model, opt = trainer.init(init)
            loss, one = step(model, opt, batch(slice(None)))
            out["one_loss"] = float(loss)
            out["one_call_ms"], out["one_card_ms"] = timed(
                model, opt, batch(slice(0, per_card)))
            del model, opt
        finally:
            ranks.set_group(group)
    model, opt = trainer.init(init)  # rank 0's weights on every rank
    local = batch(trainer._shard(per_card * n))
    ranks.reset_launches()
    loss, upd = step(model, opt, local)
    torch.cuda.synchronize(dev)
    out["launches"] = ranks.launch_counts()
    out["loss"] = float(group.all_reduce_(loss.reshape(1).float())[0]) / n
    out["checksum"] = float(sum(p.detach().double().sum()
                                for p in model.parameters()))
    out["params"] = sum(p.numel() for p in model.parameters())
    if group.rank == 0:
        out["leaf_err"] = _worst_by_leaf(_rel_l2(upd, one))
        del one
    del upd
    out["call_ms"], out["card_ms"] = timed(model, opt, local)
    if profile:
        # where an n-card step's time goes, on rank 0's card (the others
        # take the same two steps, unprofiled)
        def one():
            trainer.train_step(model, opt, local)

        if group.rank == 0:
            print_device_profile(one, f"{n}-card step on rank 0 (B={per_card}"
                                 " a card)", top=10, shares=(
                                     ("NCCL", "nccl"),
                                     ("attention kernels", "flash_"),
                                     ("GEMMs", "gemm")))
        else:
            one()
            one()
            torch.cuda.synchronize(dev)
    return out


def rank_resnet_step(per_card: int, reps: int) -> dict:
    """Rank side: the ResNet-50 train step (CIFAR stem, 32x32, AdamW, as
    in phase 7) at ``per_card`` images, timed per call and on the card:
    first on rank 0 alone (ATen's fused batch norm), the others waiting
    in the group, then on every rank at once (BatchNorm's moments over
    the ranks, written out in f32, and the gradients' all-reduce)."""
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.models import resnet
    from rafiki_tpu_torch.parallel import ranks
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_resnet

    group = ranks.current_group()
    dev = group.device
    cfg = resnet.resnet50(num_classes=CLASSES, small_inputs=True)
    rng = np.random.default_rng(SEED + 32)
    data = (torch.from_numpy(rng.random((per_card, 32, 32, 3),
                                        dtype=np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, CLASSES, per_card)).to(dev))

    def timed() -> tuple:
        with torch.device("meta"):
            model = resnet.ResNet(cfg)
        model = from_jax_tree(model, *resnet.init(np.random.default_rng(0),
                                                  cfg), dev, train=True)
        state = model.state()
        trainer = DataParallelTrainer(
            torch_resnet._loss, tunable_optimizer(
                torch.optim.AdamW, lr=1e-4, weight_decay=1e-4),
            device=dev, stateful=True)
        opt = trainer.optimizer(model.parameters())
        for _ in range(2):
            trainer.train_step(model, opt, data, state)
        torch.cuda.synchronize(dev)
        calls = []
        for _ in range(reps):
            t = time.perf_counter()
            trainer.train_step(model, opt, data, state)
            torch.cuda.synchronize(dev)
            calls.append((time.perf_counter() - t) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            trainer.train_step(model, opt, data, state)
        end.record()
        torch.cuda.synchronize(dev)
        return statistics.median(calls), start.elapsed_time(end) / reps

    out = {"rank": group.rank}
    if group.rank == 0:
        with ranks.alone():
            out["one_call_ms"], out["one_card_ms"] = timed()
    group.all_reduce_(torch.zeros(1, device=dev))  # the others wait here
    out["call_ms"], out["card_ms"] = timed()
    return out


def rank_allreduce(n_floats: int, reps: int) -> list:
    """Rank side: ms of each of ``reps`` sums of an f32 buffer of
    ``n_floats`` over the group (CUDA events), after 3 unmeasured."""
    from rafiki_tpu_torch.parallel import ranks

    group = ranks.current_group()
    buf = torch.ones(n_floats, device=group.device)
    for _ in range(3):
        group.all_reduce_(buf.fill_(1.0))
    ms = []
    for _ in range(reps):
        buf.fill_(1.0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        group.all_reduce_(buf)
        end.record()
        torch.cuda.synchronize(group.device)
        ms.append(start.elapsed_time(end))
    return ms


def nccl_transports(logs: Path) -> str:
    """The transports NCCL chose between the ranks, from its INFO lines."""
    text = "".join(p.read_text(errors="replace") for p in logs.glob("*"))
    via = sorted(set(re.findall(r" via (\S+)", text)))
    nvls = "NVLS" in text and "NVLS multicast support is available" in text
    return (", ".join(via) or "none reported") + (
        "; NVLS multicast available" if nvls else "")


def cards_own_group(card: str, n: int, profile: bool = False) -> None:
    """10a: this process as rank 0 of a group over the ``n`` cards:
    start-up, each kernel against its plain version on every card, one
    n-card step against one card's, step times at 1 and n cards, the
    all-reduce of ViT-B/16's gradients, and the ResNet-50 step at 1 and n
    cards. ``profile`` adds a kernel profile
    of one n-card step on rank 0 (not in the main run: one of the two
    processes that profiled NCCL's kernels of a group of 4 on an H100
    host aborted at its exit after passing)."""
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel import ranks
    from rafiki_tpu_torch.worker.bootstrap import KERNELS

    nccl_logs = WORK / "nccl"
    nccl_logs.mkdir(parents=True, exist_ok=True)
    for path in nccl_logs.glob("*"):
        path.unlink()
    devices = list(range(n))
    set_device_grant(devices)
    try:
        with _Env(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT",
                  NCCL_DEBUG_FILE=str(nccl_logs / "nccl.%h.%p.txt")):
            t0 = time.perf_counter()
            r = ranks.Ranks(devices)
        with r:
            up_s = time.perf_counter() - t0
            ranks.set_group(r.group)
            try:
                checks = r.run(rank_kernel_checks, SEED + 30, PER_CARD)
                steps = r.run(rank_step, SEED + 31, PER_CARD, STEP_REPS,
                              profile)
                n_floats = steps[0]["params"]
                reduce_ms = (r.run(rank_allreduce, n_floats, ALLREDUCE_REPS)
                             if n > 1 else None)
                bn_steps = r.run(rank_resnet_step, RESNET_PER_CARD,
                                 STEP_REPS)
            finally:
                ranks.set_group(None)
            startups = r.startups
            pids = r.pids
    finally:
        set_device_grant(None)
    for s in startups:
        print(f"cards: follower rank {s['rank']} (pid {s['pid']}, "
              f"{s['device']}): spawn to ready "
              f"{s['t_group'] - s['t_start']:.2f} s = interpreter, package "
              f"and torch import {s['t_main'] - s['t_start']:.2f} + CUDA init "
              f"{s['t_cuda'] - s['t_main']:.2f} + group join "
              f"{s['t_group'] - s['t_cuda']:.2f}", flush=True)
    print(f"cards: {n} rank{'s' if n > 1 else ''} up in {r.init_s:.2f} s "
          f"(first spawn to the last rank ready; {up_s:.2f} s with the "
          f"store); NCCL transport: "
          + (nccl_transports(nccl_logs) if n > 1 else "none (one rank)"),
          flush=True)
    for rec in checks:
        line = ", ".join(f"{k} {e:.3g} (tol {tol:g})"
                         for k, (e, tol) in rec["errs"].items())
        print(f"cards: kernels against their plain versions on "
              f"{rec['device']}: {line}", flush=True)
        require(all(e <= tol for e, tol in rec["errs"].values()),
                f"a kernel disagrees on {rec['device']}: {line}")
    s0 = steps[0]
    rel = abs(s0["loss"] - s0["one_loss"]) / abs(s0["one_loss"])
    print(f"cards: one step over a global batch of {PER_CARD * n} "
          f"(ViT-B/16, SGD at lr 1, weights from rank 0) on {n} card"
          f"{'s' if n > 1 else ''} against one card: loss {s0['loss']:.6f} "
          f"vs {s0['one_loss']:.6f} (relative {rel:.3g}, tol "
          f"{CARDS_LOSS_RTOL:g}); each leaf's update, relative L2 (worst "
          f"layer; tol {GRAD_RTOL:g}, {QK_GRAD_RTOL:g} for "
          f"{'/'.join(QK_LEAVES)}): "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(
              s0["leaf_err"].items())), flush=True)
    require(rel <= CARDS_LOSS_RTOL, "the n-card loss differs")
    for k, e in s0["leaf_err"].items():
        tol = QK_GRAD_RTOL if k.endswith(QK_LEAVES) else GRAD_RTOL
        require(e <= tol, f"the n-card update of {k} off by {e:.3g}")
    require(len({s["checksum"] for s in steps}) == 1,
            f"the ranks' weights differ after the step: "
            f"{[s['checksum'] for s in steps]}")
    for s in steps:
        got = [s["launches"][k] for k in KERNELS]
        require(got == [0, DEPTH, DEPTH, DEPTH],
                f"rank {s['rank']} launched {got} in one step, expected "
                f"[0, {DEPTH}, {DEPTH}, {DEPTH}]")
    print(f"cards: every rank launched K1-LSE, K2 and K3 {DEPTH} times in "
          f"the step and holds the same weights after it (checksum "
          f"{s0['checksum']:.6f})", flush=True)
    one_ips = PER_CARD / (s0["one_call_ms"] / 1e3)
    n_call = max(s["call_ms"] for s in steps)
    n_ips = PER_CARD * n / (n_call / 1e3)
    print(f"cards: the step at 1 card x {PER_CARD}: {s0['one_call_ms']:.2f} "
          f"ms a call, {s0['one_card_ms']:.2f} ms on the card; at {n} cards "
          f"x {PER_CARD}: a call " + ", ".join(
              f"rank {s['rank']} {s['call_ms']:.2f}" for s in steps)
          + " ms, on the card " + ", ".join(
              f"rank {s['rank']} {s['card_ms']:.2f}" for s in steps)
          + f" ms; train images/s {one_ips:.1f} on 1 card, {n_ips:.1f} on "
          f"{n} (the slowest rank's call), scaling {n_ips / one_ips:.2f}x; "
          f"card {card}", flush=True)
    if reduce_ms is not None:
        med = statistics.median(max(ms) for ms in zip(*reduce_ms))
        nbytes = 4 * n_floats
        bus = nbytes * 2 * (n - 1) / n / (med / 1e3)
        print(f"cards: all_reduce of {nbytes / 1e6:.1f} MB of f32 (ViT-B/16's"
              f" {n_floats} parameters) over {n} cards: median of "
              f"{ALLREDUCE_REPS} {med:.3f} ms (the slowest rank's, CUDA "
              f"events), bus bandwidth {bus / 1e9:.1f} GB/s "
              f"(2(n-1)/n x bytes / time)", flush=True)
    b0 = bn_steps[0]
    print(f"cards: ResNet-50 train step (CIFAR stem, 32x32x3, AdamW) at "
          f"{RESNET_PER_CARD} images a card: 1 card (ATen's fused batch "
          f"norm) {b0['one_call_ms']:.2f} ms a call, {b0['one_card_ms']:.2f}"
          f" ms on the card; {n} card{'s' if n > 1 else ''} (BatchNorm's "
          f"moments over the ranks, written out in f32, and the gradients' "
          f"all-reduce) a call " + ", ".join(
              f"rank {b['rank']} {b['call_ms']:.2f}" for b in bn_steps)
          + " ms, on the card " + ", ".join(
              f"rank {b['rank']} {b['card_ms']:.2f}" for b in bn_steps)
          + f" ms; card {card}", flush=True)
    require(all(np.isfinite([b["call_ms"], b["card_ms"]]).all()
                for b in bn_steps), "the ResNet-50 step times")
    alive = [p for p in pids if _alive(p)]
    require(not alive, f"followers alive after close: {alive}")


def cards_phase(card: str) -> list:
    """Phase 10; each kernel's launches on the n-card job and its serving,
    summed over the ranks, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config
    import multiprocessing

    import torch.distributed as dist

    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.worker.bootstrap import KERNELS

    t_phase = time.perf_counter()
    n = min(torch.cuda.device_count(), MAX_CARDS)
    print(f"cards: n = {n} of {torch.cuda.device_count()} visible card"
          f"{'s' if torch.cuda.device_count() > 1 else ''}"
          + ("" if n > 1 else ": one card, so the job below runs at a grant "
             "of one card (CHIPS_PER_TRIAL = CHIPS_PER_WORKER = 1) and no "
             "several-card result is claimed from this run"), flush=True)
    shm_before = set(os.listdir("/dev/shm"))
    cards_own_group(card, n)

    # ---- 10b: the job through Client, thread placement ----
    rng = np.random.default_rng(SEED + 40)
    patterns = rng.random((CLASSES, 224, 224, 3), dtype=np.float32)
    uris = {}
    for split, count in (("train", TRAIN_IMAGES * n),
                         ("test", CARDS_TEST_IMAGES)):
        x, y = make_dataset(rng, count, patterns)
        uris[split] = str(WORK / f"cards_{split}.npz")
        np.savez(uris[split], x=x, y=y)
    del x, y, patterns
    ranks_log = WORK / "cards_ranks.log"
    if ranks_log.exists():
        ranks_log.unlink()
    kernels = _kernels()
    best = config.INFERENCE_MAX_BEST_TRIALS
    body_cap = config.PREDICT_MAX_BODY_MB
    admin, server, c = _loop_stack("cards.sqlite3", WORK / "cards_params")
    door = None
    try:
        with _Fd2(ranks_log):
            c.create_model("vit-cards", "IMAGE_CLASSIFICATION", twin_template(
                "TorchViTCards", "FloatKnob(1e-5, 1e-3, is_exp=True)",
                PER_CARD * n, 1), "TorchViTCards")
            for kernel in kernels:
                kernel.launches = 0
            # ---- the main path's run: the train job ----
            t0, t0_wall = time.perf_counter(), time.time()
            c.create_train_job("cards", "IMAGE_CLASSIFICATION", uris["train"],
                               uris["test"], budget={
                                   "MODEL_TRIAL_COUNT": TRIALS,
                                   "CHIP_COUNT": n, "CHIPS_PER_TRIAL": n})
            job = c.wait_until_train_job_stopped("cards", timeout_s=900,
                                                 poll_s=0.05)
            job_s = time.perf_counter() - t0
            # ------------------------------------------------
            train_rank0 = [k.launches for k in kernels]
            trials = c.get_trials_of_train_job("cards")
            # one best trial, served on one worker of n cards
            config.INFERENCE_MAX_BEST_TRIALS = 1
            for kernel in kernels:
                kernel.launches = 0
            t_serve_wall = time.time()
            # ---- the main path's run: serving ----
            t0 = time.perf_counter()
            inf = c.create_inference_job("cards",
                                         budget={"CHIPS_PER_WORKER": n})
            deploy_s = time.perf_counter() - t0
            (served,) = {w["trial_id"] for w in inf["workers"]}
            served_path = admin.db.get_trial(served)["params_file_path"]
            images = np.random.default_rng(SEED + 41).random(
                (PER_CARD * n, 224, 224, 3), dtype=np.float32)
            answers = {k: np.asarray(c.predict("cards",
                                               images[:k].tolist()))
                       for k in (1, 8)}
            # a request of 64 images a card is larger than the door's
            # default cap
            config.PREDICT_MAX_BODY_MB = max(
                body_cap, images.nbytes / (1 << 20) + 1)
            door = PredictorServer(admin.services.get_predictor(inf["id"]),
                                   app="cards", auth=False).start()
            url = f"http://127.0.0.1:{door.port}/predict"
            sizes = tuple(sorted({1, PER_CARD, PER_CARD * n}))
            bodies = {k: request_body("npy", images[:k]) for k in sizes}
            lat = {k: [] for k in sizes}
            for _ in range(CARDS_TIMED):
                for k in sizes:
                    t = time.perf_counter()
                    got = post(url, *bodies[k])
                    lat[k].append(time.perf_counter() - t)
                    require(got.shape == (k, 1000), f"/predict {k}: shape "
                            f"{got.shape}")
            door.stop()
            door = None
            c.stop_inference_job("cards")
            # -------------------------------------
            serve_rank0 = [k.launches for k in kernels]
    finally:
        config.INFERENCE_MAX_BEST_TRIALS = best
        config.PREDICT_MAX_BODY_MB = body_cap
        if door is not None:
            door.stop()
        server.stop()
        admin.shutdown()

    require(job["status"] == "STOPPED", f"cards train job {job['status']}")
    require([w["chips"] for w in job["workers"]] == [list(range(n))],
            f"train grants {[w['chips'] for w in job['workers']]}")
    require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS
            and all(np.isfinite(t["score"]) for t in trials),
            f"trials {[(t['status'], t['score']) for t in trials]}")
    require([w["chips"] for w in inf["workers"]] == [list(range(n))],
            f"serving grants {[w['chips'] for w in inf['workers']]}")
    steps = TRIALS * (TRAIN_IMAGES * n) // (PER_CARD * n)
    # the followers' lines (a stopped serving worker closes its ranks after
    # the stop returns): the train worker's ranks started before the
    # deploy, the serving worker's after
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            len(rank_records(ranks_log, "kernel launches")) < 2 * (n - 1)
            or any(_alive(p) for p in rank_records(ranks_log, "startup"))):
        time.sleep(0.2)
    started = rank_records(ranks_log, "startup")
    counted = rank_records(ranks_log, "kernel launches")
    require(sorted(started) == sorted(counted)
            and len(started) == 2 * (n - 1),
            f"follower lines: startup {sorted(started)}, launches "
            f"{sorted(counted)} ({2 * (n - 1)} followers expected)")
    train_f = [p for p, s in started.items() if s["t_main"] < t_serve_wall]
    serve_f = [p for p in started if p not in train_f]
    train_ranks = [train_rank0] + [[counted[p][k] for k in KERNELS]
                                   for p in sorted(train_f)]
    serve_ranks = [serve_rank0] + [[counted[p][k] for k in KERNELS]
                                   for p in sorted(serve_f)]
    expect = [DEPTH * TRIALS] + [DEPTH * steps] * 3
    for r, got in enumerate(train_ranks):
        require(got == expect, f"train rank {r} launched {got}, expected "
                f"{expect} ({steps} steps, {TRIALS} evaluates)")
    # every rank answers its own part of a batch alone: rank 0's parts
    # are the larger and it alone answers a request of one image
    forwards = [got[0] // DEPTH for got in serve_ranks]
    for r, got in enumerate(serve_ranks):
        require(got == [DEPTH * forwards[r], 0, 0, 0] and forwards[r] > 0,
                f"serving rank {r} launched {got}, expected K1 alone, a "
                f"positive multiple of {DEPTH}")
    # nothing left behind
    pids = list(started)
    alive = [p for p in pids if _alive(p)]
    children = [p.name for p in multiprocessing.active_children()
                if p.name.startswith("rafiki-rank")]
    shm_new = set(os.listdir("/dev/shm")) - shm_before
    require(not alive and not children and not dist.is_initialized()
            and not shm_new, f"left behind: followers alive {alive}, "
            f"children {children}, default group {dist.is_initialized()}, "
            f"/dev/shm {sorted(shm_new)}")
    for p in sorted(started):
        s = started[p]
        print(f"cards: job follower rank {s['rank']} (pid {p}, {s['device']}"
              f", {'train' if p in train_f else 'serving'}): spawn to ready "
              f"{s['t_group'] - s['t_start']:.2f} s", flush=True)
    print(f"cards: train job of {TRIALS} trials on {n} card"
          f"{'s' if n > 1 else ''} (CHIP_COUNT = CHIPS_PER_TRIAL = {n}, batch "
          f"{PER_CARD * n}, {TRAIN_IMAGES * n} images, one epoch) STOPPED in "
          f"{job_s:.1f} s (Client.create_train_job to STOPPED); scores "
          f"{[round(t['score'], 4) for t in trials]}; launches a rank "
          f"{expect} ({steps} steps, {TRIALS} evaluates) on each of {n}; "
          f"card {card}", flush=True)

    # the answers against the same trial on one card
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel.ranks import load_params_file
    from rafiki_tpu_torch.sdk.model import load_model_class

    trial = next(t for t in trials if t["id"] == served)
    clazz = load_model_class(twin_template(
        "TorchViTCards", "FloatKnob(1e-5, 1e-3, is_exp=True)", PER_CARD * n,
        1), "TorchViTCards")
    set_device_grant([0])
    try:
        model = clazz(**trial["knobs"])
        load_params_file(model, served_path)
        ref = np.asarray(model.predict(images[:8]))
        model.destroy()
    finally:
        set_device_grant(None)
    for k, probs in answers.items():
        top2 = np.sort(ref[:k], -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > CARDS_PROB_ATOL
        same = probs.argmax(-1) == ref[:k].argmax(-1)
        err = float(np.abs(probs - ref[:k]).max())
        print(f"cards: Client.predict of {k} (JSON) on {n} card"
              f"{'s' if n > 1 else ''} against the same trial on one: argmax "
              f"equal on {int(same.sum())} of {k} ({int(clear.sum())} clear "
              f"of a near tie), max |dp| {err:.3g} (tol "
              f"{CARDS_PROB_ATOL:g})", flush=True)
        require(probs.shape == (k, 1000) and bool(np.isfinite(probs).all()),
                f"/predict/cards {k}: shape {probs.shape} or non-finite")
        require(bool(same[clear].all()) and err <= CARDS_PROB_ATOL,
                f"/predict/cards {k}: answers differ from one card's")
    p50 = {k: statistics.median(v) * 1e3 for k, v in lat.items()}
    print(f"cards: inference job on {n} card{'s' if n > 1 else ''} "
          f"(CHIPS_PER_WORKER = {n}, one worker) RUNNING in {deploy_s:.1f} "
          f"s; /predict p50 on the job's door (.npy bodies, "
          f"{CARDS_TIMED} requests a size): " + ", ".join(
              f"{k} image{'s' if k > 1 else ''} {p50[k]:.2f} ms"
              for k in sizes) + f"; bucketed forwards by rank {forwards}, "
          f"K1 {DEPTH} each; card {card}", flush=True)
    print(f"cards: after the stops no follower is alive, no default process "
          f"group exists and /dev/shm holds no new entry; phase 10 took "
          f"{time.perf_counter() - t_phase:.0f} s", flush=True)
    totals = [sum(r[i] for r in train_ranks + serve_ranks)
              for i in range(4)]
    return totals


# ---------------------------------------------------------------------------
# phase 11: image generation and tagging
# ---------------------------------------------------------------------------

GAN_IMAGES = (4096, 512)        # 11a: train and test images (32x32x3)
#: the run length each trial reads: lod 3 -> 0 (4x4 -> 32x32) within it
#: (4 kimg with 0.5-kimg phases until phase 17, 2 with 0.25-kimg phases
#: until phase 18 needed the run's time)
GAN_ENV = {"TORCHPROGAN_TOTAL_KIMG": "1", "TORCHPROGAN_PHASE_KIMG": "0.125"}
#: the step the gates take: mb 16 at lod 1.5 (stages 1 and 2 blended)
GAN_MB, GAN_LOD = 16, 1.5
# f32 on the card against the port's f32 step on the CPU: the same
# function, summed in other orders (cuDNN's algorithms, the penalty's
# double backward): losses within 1e-4 relative, each gradient leaf
# within 1e-3 relative L2
GAN_F32_LOSS_RTOL, GAN_F32_LEAF_RTOL = 1e-4, 1e-3
# bf16 on the card (the main path's type) against that f32 step, stated
# before the first chip run: losses within 2e-2 relative, each leaf
# within 5e-2 relative L2 or 1.5 times the port's bf16 step on the CPU
# from the same f32 step, whichever is larger. bf16 rounds every
# activation (2^-8 relative) through ~20 layers forward and back and the
# penalty's gradient is a difference of such terms: on the CPU at these
# widths bf16 puts the leaves 1-12% from f32
GAN_BF16_LOSS_RTOL, GAN_BF16_LEAF_RTOL, GAN_BF16_RATIO = 2e-2, 5e-2, 1.5
# a leaf's error is taken relative to its norm, but at least 1e-2 of the
# step's largest leaf norm: D's head bias gets a difference of the real
# and fake means (4e-5 against leaves of 0.1-0.4 here), which any
# rounding moves by all of itself
GAN_LEAF_FLOOR = 1e-2
# several cards against one, both f32 (phase 10's tolerances): the loss
# within 1e-3 relative, each leaf within 1e-2 relative L2. In bf16 the
# two differ by rounding alone as much as bf16 differs from f32 (each
# conv runs at another batch size: a leaf 23% apart over 2 CPU ranks),
# which would hide a fault in the group's semantics
GAN_CARDS_LEAF_RTOL = 1e-2
#: TorchProGan with the minibatch fixed at the reference's 16 (the GP
#: tunes D_repeats and the two learning rates): at the GP's minibatch 4
#: a trial took 1,000 eager D steps, 53 s of the phase on the card
PROGAN16 = """

class TorchProGan16(TorchProGan):
    @staticmethod
    def get_knob_config():
        knobs = TorchProGan.get_knob_config()
        knobs["minibatch_base"] = FixedKnob(16)
        return knobs
"""
GAN_QUERIES = [[4, 4, 16], [2, 2, 4]]
GAN_TIMED = 10                  # /predict requests of each query
POS_SIZES = (4000, 500)         # 11b: train and test sentences
POS_TOKENS = (5, 48)
POS_TAGS, POS_WORDS = 45, 5000  # the Penn Treebank's tagset size
#: TorchBiLstm with the batch fixed at its widest (the GP tunes the
#: widths, the word dropout and the learning rate): 31 steps an epoch
#: 11b's BiLSTM epochs: 2, cut for the run's time limit from the
#: template's 10 (4 until phase 17; the gates read the job's rows and
#: answers, not a score)
BILSTM_EPOCHS = 2
BILSTM_WIDE = f"""

class TorchBiLstmWide(TorchBiLstm):
    @staticmethod
    def get_knob_config():
        knobs = TorchBiLstm.get_knob_config()
        knobs["batch_size"] = FixedKnob(128)
        knobs["epochs"] = FixedKnob({BILSTM_EPOCHS})
        return knobs
"""
# one BiLSTM step at its widest knobs, f32 on the card against f32 on
# the CPU: loss within 1e-4 relative, each leaf within 1e-3 relative L2
POS_LOSS_RTOL, POS_LEAF_RTOL = 1e-4, 1e-3
POS_TIMED = 10
HMM_MIN_SCORE = 0.9


def gan_datasets() -> tuple:
    """11a's ``.npz`` sets under ``build/chip_smoke/gan/``: CIFAR-shaped
    uint8 images from phase 7's prototypes (``synthetic_cifar``)."""
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset

    rng = np.random.default_rng(SEED + 110)
    protos = rng.normal(size=(CLASSES, 8, 8, 3)).astype(np.float32)
    out = WORK / "gan"
    out.mkdir(parents=True, exist_ok=True)
    uris, first = [], None
    for split, n in zip(("train", "test"), GAN_IMAGES):
        x, y = synthetic_cifar(rng, protos, n)
        first = x if first is None else first
        uris.append(write_numpy_dataset(x, y.astype(np.int32),
                                        str(out / f"{split}.npz")))
    return uris[0], uris[1], first.astype(np.float32) / 127.5 - 1.0


def _gan_cfg(dtype):
    """The template's configuration at 32x32x3 (``TorchProGan.train``)."""
    from rafiki_tpu_torch.models.pggan import PgganConfig

    return PgganConfig(resolution=32, num_channels=3, compute_dtype=dtype)


def gan_step(g, d, cfg, reals, seed: int, group=None) -> dict:
    """One D step's and one G step's losses and gradients (no optimizer
    step) at ``GAN_LOD``, with the trainer's draws from ``seed``: the D
    step's latents and mixing weights, the G step's latents."""
    from rafiki_tpu_torch.models import pggan
    from rafiki_tpu_torch.utils import jrandom

    dev = reals.device
    max_stage = int(np.ceil(cfg.num_stages - 1 - GAN_LOD - 1e-8))
    n = GAN_MB
    key, gkey = jrandom.split(jrandom.PRNGKey(seed))
    zkey, gpkey = jrandom.split(key)

    def part(a):
        t = torch.from_numpy(a)
        if group is not None:
            k = n // group.size
            t = t[group.rank * k:(group.rank + 1) * k]
        return t.to(dev)

    z = part(jrandom.normal(zkey, (n, cfg.latent_size)))
    eps = part(jrandom.uniform(gpkey, (n, 1, 1, 1)))
    d_loss, aux = pggan.d_loss_fn(d, g, reals, z, None, GAN_LOD, eps, cfg,
                                  max_stage, group)
    pggan._grads_of(d_loss, list(d.parameters()), group)
    z = part(jrandom.normal(gkey, (n, cfg.latent_size)))
    g_loss = pggan.g_loss_fn(g, d, z, None, GAN_LOD, cfg, max_stage, group)
    pggan._grads_of(g_loss, list(g.parameters()), group)

    def mean(t):
        t = t.detach().float().reshape(1)
        if group is not None:
            t = group.all_reduce_(t.clone()) / group.size
        return float(t)

    out = {"d_loss": mean(d_loss), "gp_norm": mean(aux["gp_norm"]),
           "g_loss": mean(g_loss)}
    for prefix, model in (("d.", d), ("g.", g)):
        for name, p in model.named_parameters():
            out[prefix + name] = p.grad.detach().double().cpu()
    return out


def _gan_models(cfg, device):
    from rafiki_tpu_torch.models import pggan
    from rafiki_tpu_torch.utils import jrandom

    kg, kd = jrandom.split(jrandom.PRNGKey(SEED))
    return (pggan.build(pggan.g_init(kg, cfg), cfg, "g", device),
            pggan.build(pggan.d_init(kd, cfg), cfg, "d", device))


def _gan_errors(got: dict, ref: dict) -> tuple:
    """({loss: relative error}, {leaf: relative L2 error}) of a step's
    results against ``ref``'s (leaves that ``ref`` leaves at zero, the
    dormant stages', are not compared)."""
    losses = {k: abs(got[k] - ref[k]) / abs(ref[k])
              for k in ("d_loss", "gp_norm", "g_loss")}
    norms = {k: float(ref[k].norm()) for k in ref if k not in losses}
    floor = GAN_LEAF_FLOOR * max(norms.values())
    leaves = {k: float((got[k] - ref[k]).norm()) / max(n, floor)
              for k, n in norms.items() if n > 0}
    return losses, leaves


def _gan_compare(label: str, got: dict, ref: dict, loss_rtol: float,
                 leaf_tol) -> None:
    """Holds a step against ``ref``: each loss within ``loss_rtol``
    relative, each leaf within ``leaf_tol`` (a number, or a number a
    leaf)."""
    losses, leaves = _gan_errors(got, ref)
    tol = leaf_tol if isinstance(leaf_tol, dict) else dict.fromkeys(
        leaves, leaf_tol)
    used = {k: e / tol[k] for k, e in leaves.items()}
    worst = max(used, key=used.get)
    print(f"gan: {label}: D loss {got['d_loss']:.6f} vs {ref['d_loss']:.6f}"
          f", gp_norm {got['gp_norm']:.6f} vs {ref['gp_norm']:.6f}, G loss "
          f"{got['g_loss']:.6f} vs {ref['g_loss']:.6f} (relative "
          + ", ".join(f"{k} {e:.2e}" for k, e in losses.items())
          + f"; tol {loss_rtol:g}); gradient relative L2 per leaf: median "
          f"{statistics.median(leaves.values()):.2e}, max "
          f"{max(leaves.values()):.2e} over {len(leaves)} leaves; closest "
          f"to its tolerance {worst} {leaves[worst]:.2e} (tol "
          f"{tol[worst]:.2e})", flush=True)
    for k, e in losses.items():
        require(e <= loss_rtol, f"{label}: {k} off by {e:.3g}")
    for k, e in leaves.items():
        require(e <= tol[k], f"{label}: gradient of {k} off by {e:.3g} "
                f"(tol {tol[k]:.3g})")


def gan_step_gates(card: str, images: np.ndarray) -> None:
    """One D step (with the penalty's double backward) and one G step at
    mb 16, lod 1.5, from the same weights, batch and draws: f32 on the
    card against f32 on the CPU, and bf16 on the card against that f32
    step, beside the bf16 step on the CPU."""
    reals = torch.from_numpy(images[:GAN_MB])
    steps = {}
    for dev, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                       ("cuda:0", torch.float32),
                       ("cuda:0", torch.bfloat16)):
        cfg = _gan_cfg(dtype)
        g, d = _gan_models(cfg, dev)
        steps[dev, dtype] = gan_step(
            g, d, cfg, reals.to(next(g.parameters()).device), SEED)
    ref = steps["cpu", torch.float32]
    _, cpu_bf16 = _gan_errors(steps["cpu", torch.bfloat16], ref)
    print("gan: the bf16 step on the CPU against the f32 one, relative L2 "
          "per leaf: " + ", ".join(f"{k} {e:.2e}" for k, e in
                                  cpu_bf16.items()), flush=True)
    _gan_compare(f"one D and G step at mb {GAN_MB}, lod {GAN_LOD}, f32 on "
                 f"the card against f32 on the CPU",
                 steps["cuda:0", torch.float32], ref, GAN_F32_LOSS_RTOL,
                 GAN_F32_LEAF_RTOL)
    _gan_compare(f"the same step, bf16 on the card against f32 on the CPU",
                 steps["cuda:0", torch.bfloat16], ref, GAN_BF16_LOSS_RTOL,
                 {k: max(GAN_BF16_LEAF_RTOL, GAN_BF16_RATIO * e)
                  for k, e in cpu_bf16.items()})
    print(f"gan: the step gates passed; card {card}", flush=True)


def rank_gan_step(reals: np.ndarray) -> dict:
    """Rank side: the f32 D and G step over this thread's group (each
    rank its contiguous part of the global batch), and on rank 0 first
    the same step on one card over the whole batch."""
    from rafiki_tpu_torch.device import default_device
    from rafiki_tpu_torch.parallel import ranks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    group = ranks.current_group()
    dev = default_device()
    cfg = _gan_cfg(torch.float32)
    one = None
    if group.rank == 0:
        with ranks.alone():
            one = gan_step(*_gan_models(cfg, dev), cfg,
                           torch.from_numpy(reals).to(dev), SEED)
    k = len(reals) // group.size
    mine = torch.from_numpy(reals[group.rank * k:(group.rank + 1) * k])
    got = gan_step(*_gan_models(cfg, dev), cfg, mine.to(dev), SEED, group)
    return {"rank": group.rank, "one": one, "got": got}


def gan_cards_step(card: str, images: np.ndarray) -> None:
    """The f32 step over a group of every visible card up to 4 (one on a
    single card: a group of one rank) against one card's."""
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel import ranks

    n = min(torch.cuda.device_count(), MAX_CARDS)
    devices = list(range(n))
    set_device_grant(devices)
    try:
        with ranks.Ranks(devices) as r:
            ranks.set_group(r.group)
            try:
                out = r.run(rank_gan_step, images[:GAN_MB])
            finally:
                ranks.set_group(None)
    finally:
        set_device_grant(None)
    one = out[0]["one"]
    for rec in out:
        _gan_compare(f"rank {rec['rank']} of {n}: the step over {n} card"
                     f"{'s' if n > 1 else ''} (mb {GAN_MB // n} a card, "
                     f"minibatch stddev over the global batch) against one "
                     f"card's", rec["got"], one, CARDS_LOSS_RTOL,
                     GAN_CARDS_LEAF_RTOL)
    print(f"gan: the {n}-card step equals one card's; card {card}",
          flush=True)


def gan_step_time(card: str, images: np.ndarray) -> None:
    """The trainer's D step (with its penalty) and G step at mb 16, lod
    1.5, bf16: per call and on the card, and a profile of the D step."""
    from rafiki_tpu_torch.models import pggan
    from rafiki_tpu_torch.utils import jrandom

    trainer = pggan.PgganTrainer(_gan_cfg(torch.bfloat16), device="cuda:0")
    trainer.init_optimizers(1e-3, 1e-3)
    reals = torch.from_numpy(images[:GAN_MB]).cuda()
    key = jrandom.PRNGKey(SEED)
    max_stage = 2
    d_step = lambda: trainer.d_step(reals, None, GAN_LOD, key,  # noqa: E731
                                    GAN_MB, max_stage)
    g_step = lambda: trainer.g_step(None, GAN_LOD, key,  # noqa: E731
                                    GAN_MB, max_stage)
    times = {}
    for name, fn in (("D step", d_step), ("G step", g_step)):
        # the card held ~1 s while the host queues 5 steps (~40 ms each)
        times[name] = (median_ms(fn, reps=20),
                       device_ms(fn, reps=5, inner=5,
                                 hold_cycles=2_000_000_000))
    print("gan: at mb 16, lod 1.5, bf16: " + "; ".join(
        f"{k} {call:.2f} ms a call, {dev:.2f} ms on the card"
        for k, (call, dev) in times.items()) + f"; card {card}", flush=True)
    print_device_profile(d_step, "D step (mb 16, lod 1.5, with the "
                         "penalty's double backward)")
    del trainer


def gan_job(card: str, train_uri: str, test_uri: str) -> tuple:
    """11a's cycle through ``Client``: a 2-trial ``TorchProGan`` job (GP
    over its knobs but the minibatch, 2 kimg each), its grids on ``/predict``
    held against the trials' own ``generate``. Returns the launches of
    the job and of its serving, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.templates import torch_progan

    source = (TEMPLATES / "torch_progan.py").read_text() + PROGAN16
    admin, server, new_client = _stack("gan", "gan.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        model = c.create_model("progan", "IMAGE_GENERATION",
                               source.encode(), "TorchProGan16")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchProGan16 upload not verified: "
                f"{model['verification']}")
        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("gan", "IMAGE_GENERATION", train_uri, test_uri,
                           budget={"MODEL_TRIAL_COUNT": TRIALS,
                                   "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("gan", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        trials = c.get_trials_of_train_job("gan")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        kimg = float(GAN_ENV["TORCHPROGAN_TOTAL_KIMG"])
        for t in trials:
            logs = c.get_trial_logs(t["id"])["metrics"]
            lods = [m["lod"] for m in logs if "lod" in m]
            ticks = [m for m in logs if "kimg" in m]
            top = int(np.ceil(3 - min(lods) - 1e-8))
            require(np.isfinite(t["score"]) and 0 < t["score"] <= 1,
                    f"trial score {t['score']}")
            require(lods[0] == 3.0 and min(lods) == 0.0 and top == 3,
                    f"a trial's lods {lods[0]} .. {min(lods)}: it did not "
                    "grow to 32x32")
            wall = t["datetime_stopped"] - t["datetime_started"]
            train_s = sum(m.get("trace_train_s", 0.0) for m in logs)
            print(f"gan: trial {t['id'][:8]} COMPLETED: D_repeats "
                  f"{t['knobs']['D_repeats']}, minibatch_base "
                  f"{t['knobs']['minibatch_base']}, G_lrate "
                  f"{t['knobs']['G_lrate']:.3g}, D_lrate "
                  f"{t['knobs']['D_lrate']:.3g}; {len(ticks)} ticks, lod "
                  f"{lods[0]:g} -> {min(lods):g} (max_stage {top}), last "
                  f"d_loss {ticks[-1]['d_loss']:.4f}, g_loss "
                  f"{ticks[-1]['g_loss']:.4f}; score (1/(1+MMD)) "
                  f"{t['score']:.4f}; {kimg / train_s:.3f} kimg/s in "
                  f"train(); {wall:.2f} s in the trial: "
                  f"{trial_split(logs, wall)}", flush=True)
        print(f"gan: train job of {TRIALS} TorchProGan trials ({kimg:g} kimg "
              f"each, 32x32x3, GP) STOPPED in {job_s:.1f} s "
              f"({TRIALS * kimg / job_s:.3f} kimg/s over the job); card "
              f"{card}", flush=True)
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/gan"
        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("gan")
        deploy_s = time.perf_counter() - t0
        paths = c.predict("gan", GAN_QUERIES)
        grids = [np.load(p) for p in paths]
        lat = {}
        for q in GAN_QUERIES:
            body = (json.dumps({"queries": [q]}).encode(),
                    {"Content-Type": "application/json"})
            for _ in range(GAN_TIMED):
                t = time.perf_counter()
                post(url, *body, token=token)
                lat.setdefault(tuple(q), []).append(time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        c.stop_inference_job("gan")
    finally:
        server.stop()
        admin.shutdown()
    require(inf["status"] == "RUNNING", f"inference job {inf['status']}")
    shapes = [(4 * 32, 4 * 32, 3), (2 * 32, 2 * 32, 3)]
    require([g.shape for g in grids] == shapes
            and all(g.dtype == np.uint8 for g in grids),
            f"grids {[(g.shape, g.dtype) for g in grids]}")
    # the trials' own generate at seeds 1000 + i; both workers write the
    # same names in one working directory (the JAX template's behaviour),
    # so each file is compared with either trial's grid
    refs = []
    for t, blob in zip(trials, blobs):
        m = torch_progan.TorchProGan(**t["knobs"])
        m.load_parameters(blob)
        refs.append([torch_progan._to_grid(m._trainer.generate(
            min(q[2], q[0] * q[1]), seed=1000 + i), q[0], q[1])
            for i, q in enumerate(GAN_QUERIES)])
        del m
    errs = []
    for i, grid in enumerate(grids):
        err = min(int(np.abs(grid.astype(int) - ref[i]).max())
                  for ref in refs)
        require(err <= 1, f"grid {i} off its trials' generate by {err}")
        errs.append(err)
    p50 = {q: statistics.median(v) * 1e3 for q, v in lat.items()}
    print(f"gan: inference job RUNNING in {deploy_s:.1f} s ({TRIALS} "
          f"workers); /predict {GAN_QUERIES} wrote grids "
          f"{[g.shape for g in grids]} uint8, within {errs} of the trials' "
          f"own generate (tol 1); p50 of /predict/gan (JSON, admin door, "
          f"sequential, {GAN_TIMED} each): " + ", ".join(
              f"{list(q)} {ms:.2f} ms" for q, ms in p50.items())
          + f"; card {card}", flush=True)
    return train_counts, serve_counts


def pos_corpus() -> tuple:
    """11b's corpus zips under ``build/chip_smoke/pos/``: sentences of
    5-48 tokens whose tags follow a seeded bigram chain over 45 tags, each
    tag emitting its own ~111 words, and 1 token in 10 a word from a pool
    shared by all tags (ambiguous). Returns the train and test URIs and
    8 test sentences."""
    from rafiki_tpu_torch.sdk.dataset import write_corpus_dataset

    rng = np.random.default_rng(SEED + 111)
    trans = rng.dirichlet(np.full(POS_TAGS, 0.1), POS_TAGS)
    own = POS_WORDS * 9 // 10 // POS_TAGS
    shared = [f"s{i}" for i in range(POS_WORDS - own * POS_TAGS)]
    out = WORK / "pos"
    out.mkdir(parents=True, exist_ok=True)
    uris = []
    for split, n in zip(("train", "test"), POS_SIZES):
        sentences = []
        for _ in range(n):
            k = int(rng.integers(POS_TOKENS[0], POS_TOKENS[1] + 1))
            tag = int(rng.integers(POS_TAGS))
            toks, tags = [], []
            for _ in range(k):
                word = (shared[int(rng.integers(len(shared)))]
                        if rng.random() < 0.1 else
                        f"t{tag}w{int(rng.integers(own))}")
                toks.append(word)
                tags.append([f"T{tag}"])
                tag = int(rng.choice(POS_TAGS, p=trans[tag]))
            sentences.append((toks, tags))
        uris.append(write_corpus_dataset(sentences,
                                         str(out / f"{split}.zip")))
    return uris[0], uris[1], [s for s, _ in sentences[:8]]


def bilstm_step_gate(card: str, train_uri: str) -> None:
    """One ``TorchBiLstm`` step at its widest knobs (embed 128, hidden
    128, batch 128, the corpus's max_len 48), f32 on the card against
    f32 on the CPU, then its time on the card."""
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.models import bilstm
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_bilstm

    knobs = {"epochs": 10, "word_embed_dims": 128,
             "word_rnn_hidden_size": 128, "word_dropout": 1e-2,
             "learning_rate": 1e-2, "batch_size": 128}
    m = torch_bilstm.TorchBiLstm(**knobs)
    ids, mask, tags = m._load(train_uri, fit_vocab=True)
    cfg = m._make_cfg(128, 128)
    tree = bilstm.init(np.random.default_rng(SEED), cfg)
    batch = [torch.from_numpy(a[:128]) for a in (ids, mask, tags)]
    out = {}
    for dev in ("cpu", "cuda:0"):
        with torch.device("meta"):
            model = bilstm.BiLstm(cfg)
        model = from_jax_tree(model, tree, device=dev, train=True)
        on = next(model.parameters()).device
        loss, _ = torch_bilstm._loss(model, [t.to(on) for t in batch])
        loss.backward()
        out[dev] = (float(loss.detach()), {
            k: p.grad.detach().double().cpu()
            for k, p in model.named_parameters()})
    (loss_c, g_c), (loss_g, g_g) = out["cpu"], out["cuda:0"]
    rel = _rel_l2(g_g, g_c)
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f"pos: one TorchBiLstm step (embed 128, hidden 128, batch 128, "
          f"T {cfg.max_len}, f32) on the card against the CPU: loss "
          f"{loss_g:.6f} vs {loss_c:.6f} (relative {loss_err:.2e}, tol "
          f"{POS_LOSS_RTOL:g}); gradient relative L2 per leaf (tol "
          f"{POS_LEAF_RTOL:g}): " + ", ".join(
              f"{k} {e:.2e}" for k, e in sorted(rel.items())), flush=True)
    require(loss_err <= POS_LOSS_RTOL, "the BiLSTM loss differs")
    for k, e in rel.items():
        require(e <= POS_LEAF_RTOL, f"the BiLSTM gradient of {k} off by "
                f"{e:.3g}")
    trainer = DataParallelTrainer(torch_bilstm._loss, tunable_optimizer(
        torch.optim.Adam, lr=1e-2), device="cuda:0")
    with torch.device("meta"):
        model = bilstm.BiLstm(cfg)
    model = from_jax_tree(model, tree, device="cuda:0", train=True)
    opt = trainer.optimizer(model.parameters())
    gpu_batch = tuple(t.cuda() for t in batch)
    step = lambda: trainer.train_step(model, opt, gpu_batch)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=5, hold_cycles=2_000_000_000)
    print(f"pos: TorchBiLstm train step at batch 128 x {cfg.max_len} "
          f"tokens (f32): {call_ms:.2f} ms a call, {card_ms:.2f} ms on the "
          f"card; card {card}", flush=True)
    print_device_profile(step, "BiLSTM train step (batch 128)")


def _tag_job(c, app: str, model: str, train_uri: str, test_uri: str,
             trials: int) -> tuple:
    """A ``POS_TAGGING`` job of ``trials`` trials of ``model`` through
    ``Client`` to STOPPED: (its trials, the job's seconds)."""
    t0 = time.perf_counter()
    c.create_train_job(app, "POS_TAGGING", train_uri, test_uri,
                       budget={"MODEL_TRIAL_COUNT": trials, "CHIP_COUNT": 1},
                       models=[model])
    job = c.wait_until_train_job_stopped(app, timeout_s=900, poll_s=0.05)
    job_s = time.perf_counter() - t0
    require(job["status"] == "STOPPED", f"train job {app} {job['status']}: "
            f"{job.get('error_reason')}")
    done = c.get_trials_of_train_job(app)
    require([t["status"] for t in done] == ["COMPLETED"] * trials,
            f"trials {[(t['status'], t['fault_detail']) for t in done]}")
    for t in done:
        require(np.isfinite(t["score"]) and 0 <= t["score"] <= 1,
                f"trial score {t['score']}")
        wall = t["datetime_stopped"] - t["datetime_started"]
        print(f"pos: {model} trial {t['id'][:8]} COMPLETED: knobs "
              + (", ".join(f"{k} {v:.3g}" if isinstance(v, float) else
                           f"{k} {v}" for k, v in t["knobs"].items())
                 or "none")
              + f"; test accuracy {t['score']:.4f}; {wall:.2f} s in the "
              f"trial: {trial_split(c.get_trial_logs(t['id'])['metrics'], wall)}",
              flush=True)
    return done, job_s


def pos_jobs(card: str, train_uri: str, test_uri: str,
             queries: list) -> tuple:
    """11b's jobs through ``Client``: 2 ``TorchBiLstm`` trials (app
    ``pos``) and 1 ``NpBigramHmm`` trial (app ``hmm``; the budget's trial
    count is per model, so the two are two jobs), each deployed and
    asked to tag 8 sentences. Returns the launches of the jobs and of
    their serving."""
    admin, server, new_client = _stack("pos", "pos.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        for name, source, cls in (
                ("bilstm", (TEMPLATES / "torch_bilstm.py").read_text()
                 + BILSTM_WIDE, "TorchBiLstmWide"),
                ("hmm", (TEMPLATES / "np_bigram_hmm.py").read_text(),
                 "NpBigramHmm")):
            model = c.create_model(name, "POS_TAGGING", source.encode(), cls)
            require(model["verification"] is not None
                    and model["verification"]["ok"],
                    f"{cls} upload not verified: {model['verification']}")
        # ---- the main path's run (train jobs): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        bilstm_trials, bilstm_s = _tag_job(c, "pos", "bilstm", train_uri,
                                           test_uri, TRIALS)
        hmm_trials, hmm_s = _tag_job(c, "hmm", "hmm", train_uri, test_uri, 1)
        torch.cuda.synchronize()
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        print(f"pos: the BiLSTM job ({TRIALS} trials, {BILSTM_EPOCHS} epochs "
              f"of "
              f"{POS_SIZES[0]} sentences each) STOPPED in {bilstm_s:.1f} s, "
              f"the HMM job (1 trial) in {hmm_s:.1f} s; card {card}",
              flush=True)
        require(hmm_trials[0]["score"] >= HMM_MIN_SCORE,
                f"the HMM scored {hmm_trials[0]['score']:.4f} (at least "
                f"{HMM_MIN_SCORE} on this grammar)")
        # ---- the main path's run (inference jobs): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        tags, lat, deploy = {}, {}, {}
        for app in ("pos", "hmm"):
            t0 = time.perf_counter()
            inf = c.create_inference_job(app)
            deploy[app] = time.perf_counter() - t0
            require(inf["status"] == "RUNNING",
                    f"inference job {app} {inf['status']}")
            tags[app] = c.predict(app, queries)
            for _ in range(POS_TIMED):
                t = time.perf_counter()
                c.predict(app, queries)
                lat.setdefault(app, []).append(time.perf_counter() - t)
            c.stop_inference_job(app)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
    finally:
        server.stop()
        admin.shutdown()
    for app, rows in tags.items():
        require([len(r) for r in rows] == [len(q) for q in queries],
                f"{app}: tag lists of {[len(r) for r in rows]} for "
                f"sentences of {[len(q) for q in queries]}")
        require(all(t.startswith("T") for r in rows for t in r),
                f"{app}: tags {rows[0][:5]}")
    agree = np.mean([a == b for ra, rb in zip(tags["pos"], tags["hmm"])
                     for a, b in zip(ra, rb)])
    print(f"pos: both jobs deployed (BiLSTM {deploy['pos']:.1f} s, HMM "
          f"{deploy['hmm']:.1f} s) and tagged 8 sentences of "
          f"{[len(q) for q in queries]} tokens, a tag a token (the two "
          f"agree on {agree:.3f} of the tokens); p50 of Client.predict "
          f"(the admin door, 8 sentences, {POS_TIMED} requests): BiLSTM "
          f"{statistics.median(lat['pos']) * 1e3:.2f} ms, HMM "
          f"{statistics.median(lat['hmm']) * 1e3:.2f} ms; card {card}",
          flush=True)
    return train_counts, serve_counts


def generation_tagging_phase(card: str) -> list:
    """Phase 11: 11a image generation, 11b tagging. Returns each kernel's
    launches on this path, in ``KERNEL_NAMES`` order (none is on it)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    train_uri, test_uri, images = gan_datasets()
    print(f"gan: synthetic CIFAR-shaped sets ({GAN_IMAGES[0]} + "
          f"{GAN_IMAGES[1]} images, 32x32x3 uint8) written as .npz in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gan_step_gates(card, images)
    gan_cards_step(card, images)
    cwd = os.getcwd()
    os.chdir(WORK / "gan")  # predict writes its grids to the cwd
    try:
        with _Env(**GAN_ENV):
            gan_train, gan_serve = gan_job(card, train_uri, test_uri)
    finally:
        os.chdir(cwd)
    gan_step_time(card, images)
    t_gan = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    train_uri, test_uri, queries = pos_corpus()
    print(f"pos: synthetic tagged corpus ({POS_SIZES[0]} + {POS_SIZES[1]} "
          f"sentences of {POS_TOKENS[0]}-{POS_TOKENS[1]} tokens, "
          f"{POS_WORDS} words, {POS_TAGS} tags) written as corpus zips in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bilstm_step_gate(card, train_uri)
    pos_train, pos_serve = pos_jobs(card, train_uri, test_uri, queries)
    counts = [sum(c) for c in zip(gan_train, gan_serve, pos_train,
                                  pos_serve)]
    require(counts == [0] * len(KERNEL_NAMES),
            f"the generation and tagging paths launched attention kernels: "
            f"{counts}")
    print(f"gan: 11a took {t_gan:.0f} s; pos: 11b took "
          f"{time.perf_counter() - t_phase - t_gan:.0f} s; phase 11 took "
          f"{time.perf_counter() - t_phase:.0f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 14: populations and int8 serving
# ---------------------------------------------------------------------------

#: 14a: TorchCnn at its widest knobs on 11a's set, K learning rates
POP_STAGES, POP_BASE, POP_BATCH = 3, 64, 256
POP_LRS = tuple(float(v) for v in np.geomspace(1e-4, 1e-2, 4))
#: the rows of the batch the CPU's f32 step takes (the whole batch is ~1
#: TFLOP a member forward and back, tens of seconds on the CPU)
POP_CHECK_ROWS = 64
# f32 on the card against f32 on the CPU: the same function summed in
# other orders (cuDNN's grouped convolutions): losses within 1e-4
# relative, each member's gradient leaf within 1e-3 relative L2
POP_F32_LOSS_RTOL, POP_F32_LEAF_RTOL = 1e-4, 1e-3
# bf16 on the card (the main path's type) against that f32 step, fixed
# before any measurement: losses within 2e-2 relative, each leaf within
# 5e-2 relative L2 (11a's bounds: bf16 rounds every activation, 2^-8
# relative, through 7 convolutions forward and back)
POP_BF16_LOSS_RTOL, POP_BF16_LEAF_RTOL = 2e-2, 5e-2
# a leaf's error relative to its norm, but at least 1e-2 of the member's
# largest leaf norm (11a's floor: a bias whose gradient is a near-zero
# sum of signed terms)
POP_LEAF_FLOOR = 1e-2
# each member of the f32 population against a DataParallelTrainer of
# that member alone (f32; cuDNN's grouped against plain convolutions;
# both through torch.optim.AdamW, the population's with one parameter
# group a member): one step's gradients within 1e-3 relative L2 a leaf
# (the f32 step's tolerance above). AdamW's first step moves a weight by
# lr·g/(|g| + eps), about lr·sign(g), so where rounding flips a
# near-zero gradient the two updates part by 2·lr (measured on one H100:
# 1.4e-2 relative L2 over a whole leaf). The first step's update is held
# over the elements whose two gradients agree in sign and both exceed
# POP_GRAD_MARGIN (100 eps), within POP_UPDATE_RTOL relative L2 a leaf
# (measured on one H100: 2.41e-5 at most), and those elements must be
# at least POP_UPDATE_COVER of every leaf (measured: 0.877 at least, a
# stage-2 kernel's). The epoch (16 steps, where the flipped elements'
# updates feed later gradients) is held by each member's mean loss
# (measured in four runs: 6.84e-4 to 4.37e-3 relative); its update drift
# is printed.
POP_SCALAR_RTOL = 1e-3
POP_GRAD_MARGIN = 1e-6
POP_UPDATE_COVER = 0.75
POP_UPDATE_RTOL = 1e-4
POP_EPOCH_LOSS_RTOL = 2e-2
#: 14b: the TorchCnn twin's fixed knobs, and the jobs' trial counts
POP_TWIN_KNOBS = {"epochs": 2, "num_stages": 3, "base_channels": 64,
                  "batch_size": 128}
POP_TRIALS, POP_VMAP_K, POP_SCALAR_TRIALS = 8, 4, 4
#: 14c: the TorchCnnPopulation twin's fixed knobs (one trial)
POP_TEMPLATE_KNOBS = {"epochs": 2, "base_channels": 32,
                      "population_size": 8, "batch_size": 256}
#: 14d: timed JSON requests of 8 sentences on the admin door, each way
INT8_TIMED = 10
#: JAX's rule for int8 against bf16 serving (tests/test_quant.py:84-103)
INT8_AGREE, INT8_ATOL = 0.99, 0.15
#: the sentences of the int8 forward on the CPU (a BERT-base forward of
#: 8 x 128 tokens takes ~10 s on 8 cores in bf16)
INT8_CPU_ROWS = 2
#: the fused int8 answers against each trial's solo int8 answers: bf16
#: on the card rounds the stacked (batched) products and a trial's own
#: apart by up to 9.1e-4 in probability (measured on one H100, a
#: 2-layer BERT), past tests/test_fused_ensemble.py:125's 1e-4, which
#: tests/test_torch_cuda.py holds in f32; here PROB_RTOL p + PROB_ATOL,
#: phase 12b's rule for fused against unfused, with the 1e-4 printed


@contextlib.contextmanager
def _compute(dtype):
    """The port's layers compute in ``dtype`` (``core.cast_for_compute``)
    for the block."""
    from rafiki_tpu_torch.models import core

    saved = core.cast_for_compute
    core.cast_for_compute = lambda x, _d=dtype: saved(x, _d)
    try:
        yield
    finally:
        core.cast_for_compute = saved


def _pop_trainer(device):
    from rafiki_tpu_torch.sdk.population import PopulationTrainer
    from rafiki_tpu_torch.sdk.torch_backend import softmax_classifier_loss
    from rafiki_tpu_torch.templates import torch_cnn

    return PopulationTrainer(softmax_classifier_loss(torch_cnn._logits),
                             torch_cnn._adamw(lr=1e-3),
                             predict_fn=torch_cnn._probs, device=device)


def _pop_member(k: int, device):
    """Member ``k`` of 14a's population: TorchCnn's ``Cnn`` at 3 stages,
    64 base channels, 10 classes, from its seeded draw."""
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.templates import torch_cnn

    tree = torch_cnn.init_params(np.random.default_rng([SEED + 140, k]),
                                 POP_STAGES, POP_BASE, 3, CLASSES)
    with torch.device("meta"):
        model = torch_cnn.Cnn(POP_STAGES, POP_BASE, 3, CLASSES)
    return from_jax_tree(model, tree, None, device, train=True)


def pop_grads(x: np.ndarray, y: np.ndarray, device) -> dict:
    """Every member's loss and gradients of one batch (no optimizer step),
    over this thread's group when it has one (each rank its contiguous
    part of the batch); {"loss": (K,), "<k>.<leaf>": gradient}."""
    from rafiki_tpu_torch.parallel import ranks

    group = ranks.current_group()
    if group is not None:
        part = len(x) // group.size
        x = x[group.rank * part:(group.rank + 1) * part]
        y = y[group.rank * part:(group.rank + 1) * part]
    trainer = _pop_trainer(device)
    params, _ = trainer.stack([_pop_member(k, trainer.device)
                               for k in range(len(POP_LRS))],
                              {"lr": list(POP_LRS)})
    grads, losses = trainer.grads(params, (
        torch.from_numpy(np.ascontiguousarray(x)).to(trainer.device),
        torch.from_numpy(np.ascontiguousarray(y)).to(trainer.device)))
    losses = losses.double()
    if group is not None:
        losses = group.all_reduce_(losses) / group.size
    out = {"loss": losses.cpu().numpy()}
    for name, g in grads.items():
        for k in range(len(POP_LRS)):
            out[f"{k}.{name[len('model.'):]}"] = g[k].detach().double().cpu()
    return out


def _pop_errors(got: dict, ref: dict) -> tuple:
    """(losses' relative errors (K,), {member.leaf: relative L2 error})."""
    losses = np.abs(got["loss"] - ref["loss"]) / np.abs(ref["loss"])
    norms = {k: float(v.norm()) for k, v in ref.items() if k != "loss"}
    floors = {}
    for k, n in norms.items():
        member = k.split(".", 1)[0]
        floors[member] = max(floors.get(member, 0.0), POP_LEAF_FLOOR * n)
    leaves = {k: float((got[k] - ref[k]).norm())
              / max(n, floors[k.split(".", 1)[0]], 1e-30)
              for k, n in norms.items()}
    return losses, leaves


def _pop_compare(label: str, got: dict, ref: dict, loss_rtol: float,
                 leaf_rtol: float) -> None:
    losses, leaves = _pop_errors(got, ref)
    worst = max(leaves, key=leaves.get)
    print(f"pop: {label}: member losses {np.round(got['loss'], 6).tolist()}"
          f" vs {np.round(ref['loss'], 6).tolist()} (relative at most "
          f"{losses.max():.2e}, tol {loss_rtol:g}); gradient relative L2 "
          f"per member and leaf: median "
          f"{statistics.median(leaves.values()):.2e}, max {leaves[worst]:.2e}"
          f" ({worst}) over {len(leaves)} (tol {leaf_rtol:g})", flush=True)
    require(float(losses.max()) <= loss_rtol,
            f"{label}: member losses off by {losses.max():.3g}")
    require(leaves[worst] <= leaf_rtol,
            f"{label}: gradient of {worst} off by {leaves[worst]:.3g}")


def pop_step_gates(card: str, x: np.ndarray, y: np.ndarray) -> None:
    """14a's step gates on the first ``POP_CHECK_ROWS`` rows of a batch:
    f32 on the card against f32 on the CPU, bf16 on the card against it."""
    xb, yb = x[:POP_CHECK_ROWS], y[:POP_CHECK_ROWS]
    steps = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda:0", torch.float32),
                       ("cuda:0", torch.bfloat16)):
        with _compute(dtype):
            steps[dev, dtype] = pop_grads(xb, yb, dev)
    ref = steps["cpu", torch.float32]
    # member 0 alone on the card (no vmap: plain, not grouped,
    # convolutions), f32, against the same CPU step: where an f32
    # difference comes from
    from rafiki_tpu_torch.sdk.torch_backend import softmax_classifier_loss
    from rafiki_tpu_torch.templates import torch_cnn

    with _compute(torch.float32):
        model = _pop_member(0, "cuda:0")
        loss, _ = softmax_classifier_loss(torch_cnn._logits)(model, (
            torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda()))
        loss.backward()
    alone = {f"0.{n}": p.grad.double().cpu()
             for n, p in model.named_parameters()}
    alone_err = max(float((g - ref[k]).norm() / ref[k].norm())
                    for k, g in alone.items())
    print(f"pop: member 0 alone on the card (plain convolutions), f32, "
          f"against the CPU: gradient relative L2 at most {alone_err:.2e}",
          flush=True)
    _pop_compare(f"one population step (K={len(POP_LRS)}, {POP_CHECK_ROWS} "
                 "rows), f32 on the card against f32 on the CPU",
                 steps["cuda:0", torch.float32], ref, POP_F32_LOSS_RTOL,
                 POP_F32_LEAF_RTOL)
    _pop_compare("the same step, bf16 on the card against f32 on the CPU",
                 steps["cuda:0", torch.bfloat16], ref, POP_BF16_LOSS_RTOL,
                 POP_BF16_LEAF_RTOL)
    print(f"pop: the step gates passed; card {card}", flush=True)


def rank_pop_step(x: np.ndarray, y: np.ndarray) -> dict:
    """Rank side: the f32 population step over this thread's group, and on
    rank 0 first the same step on one card over the whole batch."""
    from rafiki_tpu_torch.device import default_device
    from rafiki_tpu_torch.parallel import ranks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    group = ranks.current_group()
    dev = default_device()
    one = None
    with _compute(torch.float32):
        if group.rank == 0:
            with ranks.alone():
                one = pop_grads(x, y, dev)
        got = pop_grads(x, y, dev)
    return {"rank": group.rank, "one": one, "got": got}


def pop_cards_step(card: str, x: np.ndarray, y: np.ndarray) -> None:
    """The f32 population step over a group of every visible card up to 4
    (a group of one rank on a single card) against one card's."""
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel import ranks

    n = min(torch.cuda.device_count(), MAX_CARDS)
    devices = list(range(n))
    set_device_grant(devices)
    try:
        with ranks.Ranks(devices) as r:
            ranks.set_group(r.group)
            try:
                out = r.run(rank_pop_step, x[:POP_BATCH], y[:POP_BATCH])
            finally:
                ranks.set_group(None)
    finally:
        set_device_grant(None)
    for rec in out:
        _pop_compare(f"rank {rec['rank']} of {n}: the step over {n} card"
                     f"{'s' if n > 1 else ''} ({POP_BATCH // n} rows a card, "
                     f"each member's gradients averaged over the ranks) "
                     f"against one card's", rec["got"], out[0]["one"],
                     CARDS_LOSS_RTOL, GAN_CARDS_LEAF_RTOL)
    print(f"pop: the {n}-card population step equals one card's; card "
          f"{card}", flush=True)


def pop_epoch(card: str, x: np.ndarray, y: np.ndarray) -> None:
    """14a: one population epoch (f32) against each member's scalar
    ``DataParallelTrainer`` fit, then the main path's bf16 epoch, the
    population step's time and profile beside K scalar steps."""
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
    )
    from rafiki_tpu_torch.templates import torch_cnn

    k_members = len(POP_LRS)
    batch = (torch.from_numpy(x[:POP_BATCH]).cuda(),
             torch.from_numpy(y[:POP_BATCH]).cuda())

    def scalar_member(k: int):
        scalar = DataParallelTrainer(
            softmax_classifier_loss(torch_cnn._logits), torch_cnn._adamw(),
            device="cuda:0")
        model, mopt = scalar.init(lambda rng: _pop_member(k, "cuda:0"),
                                  hyperparams={"lr": POP_LRS[k]})
        return scalar, model, mopt

    def drift(params, init, models) -> list:
        """Each member's worst leaf: its update's relative L2 distance
        from its scalar twin's."""
        worst = []
        for k, model in enumerate(models):
            errs = {}
            for name, p in model.named_parameters():
                full = "model." + name
                want = p.detach().double() - init[full][k].double()
                got = params.params[full][k].double() - init[full][k].double()
                errs[name] = float((got - want).norm() / want.norm())
            worst.append(max((e, n) for n, e in errs.items()))
        return worst

    with _compute(torch.float32):
        # one step: each member's gradients are its scalar step's
        trainer = _pop_trainer("cuda:0")
        params, opt = trainer.stack([_pop_member(k, "cuda:0")
                                     for k in range(k_members)],
                                    {"lr": list(POP_LRS)})
        init = {n: v.clone() for n, v in params.params.items()}
        grads, _ = trainer.grads(params, batch)
        trainer.apply_(params, opt, grads)
        step_drift, update_drift, cover = [], [], []
        for k in range(k_members):
            scalar, model, mopt = scalar_member(k)
            scalar.train_step(model, mopt, batch)
            g_errs, u_errs = [], []
            for n, p in model.named_parameters():
                full = "model." + n
                g_pop, g_one = grads[full][k].double(), p.grad.double()
                g_errs.append((float((g_pop - g_one).norm()
                                     / g_one.norm()), n))
                u_pop = params.params[full][k].double() - init[full][k]
                u_one = p.detach().double() - init[full][k]
                held = ((torch.sign(g_pop) == torch.sign(g_one))
                        & (torch.minimum(g_pop.abs(), g_one.abs())
                           > POP_GRAD_MARGIN))
                cover.append((float(held.double().mean()), f"{k}.{n}"))
                u_errs.append((float((u_pop - u_one)[held].norm()
                                     / u_one[held].norm().clamp_min(1e-30)),
                               n))
            step_drift.append(max(g_errs))
            update_drift.append(max(u_errs))
            del scalar, model, mopt
        # one epoch: 16 steps from the same init and batches
        params, opt = trainer.stack([_pop_member(k, "cuda:0")
                                     for k in range(k_members)],
                                    {"lr": list(POP_LRS)})
        logs = []
        trainer.fit(params, opt, (x, y), epochs=1, batch_size=POP_BATCH,
                    seed=SEED, log=lambda **m: logs.append(m))
        twins, scalar_losses = [scalar_member(k) for k in range(k_members)], []
        for scalar, model, mopt in twins:
            scalar_logs = []
            scalar.fit(model, mopt, (x, y), epochs=1, batch_size=POP_BATCH,
                       seed=SEED, log=lambda **m: scalar_logs.append(m))
            scalar_losses.append(scalar_logs[0]["loss"])
        epoch_drift = drift(params, init, [m for _, m, _ in twins])
    member_losses = [logs[0][f"member{k}_loss"] for k in range(k_members)]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(member_losses, scalar_losses))
    print(f"pop: each member of the f32 population against its own "
          f"DataParallelTrainer (same init, lr and batches; "
          f"torch.optim.AdamW): one step's gradients relative L2 at most "
          f"{max(step_drift)[0]:.2e} ({max(step_drift)[1]}; tol "
          f"{POP_SCALAR_RTOL:g}); its update, over the elements whose "
          f"gradients agree in sign past {POP_GRAD_MARGIN:g} (at least "
          f"{min(cover)[0]:.4f} of a leaf, {min(cover)[1]}; tol "
          f"{POP_UPDATE_COVER:g}), relative L2 per member "
          + ", ".join(f"lr {lr:.0e} {e:.2e} ({n})" for lr, (e, n) in
                      zip(POP_LRS, update_drift))
          + f" (tol {POP_UPDATE_RTOL:g}); one epoch ({len(x) // POP_BATCH} "
          f"steps): "
          f"losses {[round(v, 6) for v in member_losses]} against "
          f"{[round(v, 6) for v in scalar_losses]} (relative at most "
          f"{loss_err:.2e}, tol {POP_EPOCH_LOSS_RTOL:g}), each member's "
          f"worst leaf's update drift "
          + ", ".join(f"lr {lr:.0e} {e:.2e} ({n})" for lr, (e, n) in
                      zip(POP_LRS, epoch_drift)), flush=True)
    require(max(step_drift)[0] <= POP_SCALAR_RTOL,
            f"a member's step differs from its scalar step: {step_drift}")
    require(min(cover)[0] >= POP_UPDATE_COVER,
            f"the update check holds too few elements: {min(cover)}")
    require(max(update_drift)[0] <= POP_UPDATE_RTOL,
            f"a member's first update differs from its scalar update: "
            f"{update_drift}")
    require(loss_err <= POP_EPOCH_LOSS_RTOL,
            f"a member's epoch loss differs from its scalar fit's by "
            f"{loss_err:.3g}")
    del params, opt, init

    # the main path's type: bf16
    trainer = _pop_trainer("cuda:0")
    params, opt = trainer.stack([_pop_member(k, "cuda:0")
                                 for k in range(k_members)],
                                {"lr": list(POP_LRS)})
    logs = []
    t0 = time.perf_counter()
    trainer.fit(params, opt, (x, y), epochs=1, batch_size=POP_BATCH,
                seed=SEED, log=lambda **m: logs.append(m))
    epoch_s = time.perf_counter() - t0
    steps = len(x) // POP_BATCH
    (m,) = logs
    members = [m[f"member{k}_loss"] for k in range(k_members)]
    require(all(np.isfinite(members)), f"population losses {members}")
    grad_fn = trainer._grad_fn(params)
    step = lambda: trainer.step(params, opt, batch, grad_fn)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=5, hold_cycles=200_000_000)
    scalar = DataParallelTrainer(
        softmax_classifier_loss(torch_cnn._logits),
        torch_cnn._adamw(), device="cuda:0")
    alone = [scalar.init(lambda rng: _pop_member(k, "cuda:0"),
                         hyperparams={"lr": lr})
             for k, lr in enumerate(POP_LRS)]
    k_steps = lambda: [scalar.train_step(mm, oo, batch)  # noqa: E731
                       for mm, oo in alone]
    k_call_ms = median_ms(k_steps, reps=10)
    k_card_ms = device_ms(k_steps, reps=3, inner=5,
                          hold_cycles=200_000_000)
    print(f"pop: 14a one bf16 population epoch of TorchCnn ({POP_STAGES} "
          f"stages, {POP_BASE} base channels, 32x32x3, K={k_members} "
          f"learning rates "
          f"{[f'{lr:.0e}' for lr in POP_LRS]}, batch {POP_BATCH}, {steps} "
          f"steps): {epoch_s:.2f} s, member losses "
          f"{[round(v, 4) for v in members]}; the population step "
          f"{call_ms:.2f} ms a call, {card_ms:.2f} ms on the card; "
          f"{k_members} scalar steps {k_call_ms:.2f} ms a call, "
          f"{k_card_ms:.2f} ms on the card; card {card}", flush=True)
    print_device_profile(step, f"population step (K={k_members}, batch "
                         f"{POP_BATCH}, bf16)", shares=(
                             ("convolutions", "conv"),
                             ("cuDNN's grouped kernels", "grouped")))
    print_device_profile(k_steps, f"{k_members} scalar steps (batch "
                         f"{POP_BATCH}, bf16)", shares=(
                             ("convolutions", "conv"),))
    del trainer, params, opt, alone, scalar


def cnn_twin(source_name: str, cls: str, new_cls: str, fixed: dict) -> bytes:
    """A template of ``templates/`` renamed ``new_cls`` with the knobs in
    ``fixed`` fixed."""
    source = (TEMPLATES / source_name).read_text()
    require(source.count(f"class {cls}(BaseModel):") == 1, cls)
    source = source.replace(f"class {cls}(BaseModel):",
                            f"class {new_cls}(BaseModel):")
    for knob, value in fixed.items():
        found = re.findall(rf'"{knob}": \w+Knob\([^)]*\)', source)
        require(len(found) == 1, f"knob {knob} in {source_name}")
        source = source.replace(found[0], f'"{knob}": FixedKnob({value})')
    return source.encode()


def pop_jobs(card: str, train_uri: str, test_uri: str, x: np.ndarray
             ) -> list:
    """14b: a TorchCnn twin job whose proposals differ only in the
    learning rate (K=4 populations), served, beside its scalar twin; 14c:
    a one-trial TorchCnnPopulation job (population_size 8), served.
    Returns each kernel's launches on these paths (none is on them)."""
    from rafiki_tpu_torch.sdk import population
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params

    twin = cnn_twin("torch_cnn.py", "TorchCnn", "TorchCnnTwin",
                    POP_TWIN_KNOBS)
    pop8 = cnn_twin("torch_cnn_population.py", "TorchCnnPopulation",
                    "TorchCnnPopulation8", POP_TEMPLATE_KNOBS)
    queries = x[:8]
    kernels = _kernels()
    admin, server, new_client = _stack("pop", "pop.sqlite3")
    try:
        c = new_client()
        for name, source, cls in (("cnn-twin", twin, "TorchCnnTwin"),
                                  ("cnn-pop8", pop8, "TorchCnnPopulation8")):
            model = c.create_model(name, "IMAGE_CLASSIFICATION", source, cls)
            require(model["verification"] is not None
                    and model["verification"]["ok"],
                    f"{cls} upload not verified: {model['verification']}")
        # ---- the main path's runs: counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        population.reset_fit_stats()
        t0 = time.perf_counter()
        c.create_train_job("cnnpop", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": POP_TRIALS,
                                             "CHIP_COUNT": 1,
                                             "TRIAL_VMAP_K": POP_VMAP_K},
                           models=["cnn-twin"])
        job = c.wait_until_train_job_stopped("cnnpop", timeout_s=900,
                                             poll_s=0.05)
        pop_s = time.perf_counter() - t0
        fits = dict(population.FIT_STATS)
        with _Env(RAFIKI_TRIAL_VMAP="0"):
            t0 = time.perf_counter()
            c.create_train_job("cnnscalar", "IMAGE_CLASSIFICATION",
                               train_uri, test_uri, budget={
                                   "MODEL_TRIAL_COUNT": POP_SCALAR_TRIALS,
                                   "CHIP_COUNT": 1,
                                   "TRIAL_VMAP_K": POP_VMAP_K},
                               models=["cnn-twin"])
            scalar_job = c.wait_until_train_job_stopped(
                "cnnscalar", timeout_s=900, poll_s=0.05)
            scalar_s = time.perf_counter() - t0
        require(population.FIT_STATS["member_counts"] == fits[
            "member_counts"], "RAFIKI_TRIAL_VMAP=0 still fitted populations")
        # 14c (trained before the deploys: a train job takes its card
        # alone, and a stopped inference job's workers free theirs later)
        population.reset_fit_stats()
        t0 = time.perf_counter()
        c.create_train_job("cnnpop8", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": 1,
                                             "CHIP_COUNT": 1},
                           models=["cnn-pop8"])
        job8 = c.wait_until_train_job_stopped("cnnpop8", timeout_s=900,
                                              poll_s=0.05)
        pop8_s = time.perf_counter() - t0
        fits8 = dict(population.FIT_STATS)
        (trial8,) = c.get_trials_of_train_job("cnnpop8")
        winner = [m for m in c.get_trial_logs(trial8["id"])["metrics"]
                  if "best_member" in m]
        trials = c.get_trials_of_train_job("cnnpop")
        epoch_logs = {t["id"]: [m for m in c.get_trial_logs(t["id"])[
            "metrics"] if "epoch" in m] for t in trials}
        heads = {t["id"]: load_params(c.download_trial_params(t["id"]))[
            "params"]["head"]["kernel"].tobytes() for t in trials}
        inf = c.create_inference_job("cnnpop")
        served = np.asarray(c.predict("cnnpop", queries.tolist()))
        best = [t for t in trials if t["id"] in
                {w["trial_id"] for w in inf["workers"]}]
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in best]
        c.stop_inference_job("cnnpop")
        c.create_inference_job("cnnpop8")
        served8 = np.asarray(c.predict("cnnpop8", queries.tolist()))
        blob8 = load_params(c.download_trial_params(trial8["id"]))
        c.stop_inference_job("cnnpop8")
        counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
    finally:
        server.stop()
        admin.shutdown()
    require(job["status"] == scalar_job["status"] == job8["status"]
            == "STOPPED", f"jobs {job['status']}, {scalar_job['status']}, "
            f"{job8['status']}")
    # populations that began AND returned: a batch whose fit raised is
    # re-run member by member as scalar trials under the same ids, which
    # would pass every check below
    batches = [POP_VMAP_K] * (POP_TRIALS // POP_VMAP_K)
    require(fits["member_counts"] == fits["completed_member_counts"]
            == batches, f"fits begun {fits['member_counts']}, returned "
            f"{fits['completed_member_counts']}")
    # each batch's training log is on its lead row, every epoch with each
    # member's loss; no other row holds an epoch (a scalar fit's log)
    leads = {tid: logs for tid, logs in epoch_logs.items() if logs}
    member_keys = {f"member{k}_loss" for k in range(POP_VMAP_K)}
    epochs = [float(e) for e in range(POP_TWIN_KNOBS["epochs"])]
    shapes = {tid: [sorted(m) for m in logs]
              for tid, logs in epoch_logs.items()}
    require(len(leads) == len(batches) and all(
        [m["epoch"] for m in logs] == epochs
        and all(member_keys <= set(m) for m in logs)
        for logs in leads.values()), f"epoch logs per row: {shapes}")
    require(len(trials) == POP_TRIALS
            and all(t["status"] == "COMPLETED" and np.isfinite(t["score"])
                    for t in trials),
            f"trials {[(t['status'], t['score']) for t in trials]}")
    require(len(set(heads.values())) == POP_TRIALS,
            "two members' parameters artifacts hold the same weights")
    # the served ensemble against the best trials' own predict on the card
    clazz = load_model_class(twin, "TorchCnnTwin")
    own = []
    for t, blob in zip(best, blobs):
        m = clazz(**t["knobs"])
        m.load_parameters(blob)
        own.append(np.asarray(m.predict(queries.tolist())))
    err = float(np.abs(served - sum(own) / len(own)).max())
    require(served.shape == (8, CLASSES) and err <= ENSEMBLE_ATOL,
            f"/predict/cnnpop off its trials' mean by {err:.3g}")
    per_hour = POP_TRIALS / pop_s * 3600
    scalar_per_hour = POP_SCALAR_TRIALS / scalar_s * 3600
    print(f"pop: 14b TorchCnn twin ({POP_TWIN_KNOBS}; the learning rate "
          f"free) through Client: {POP_TRIALS} trials at TRIAL_VMAP_K "
          f"{POP_VMAP_K} fitted as {fits['member_counts']} (each fit "
          f"returned; {len(leads)} lead rows log each member's loss each "
          f"epoch, the other {POP_TRIALS - len(leads)} no epoch), every row "
          f"COMPLETED with its own score and params (scores "
          f"{[round(t['score'], 4) for t in trials]}), STOPPED in "
          f"{pop_s:.1f} s ({per_hour:.0f} trials per GPU-hour); the scalar "
          f"twin (RAFIKI_TRIAL_VMAP=0) {POP_SCALAR_TRIALS} trials in "
          f"{scalar_s:.1f} s ({scalar_per_hour:.0f} trials per GPU-hour, "
          f"{per_hour / scalar_per_hour:.2f}x); the best {len(best)} "
          f"served: /predict of 8 images within {err:.2e} of their own "
          f"predict (tol {ENSEMBLE_ATOL:g}); card {card}", flush=True)
    require(job8["status"] == "STOPPED" and trial8["status"] == "COMPLETED"
            and fits8["member_counts"] == fits8["completed_member_counts"]
            == [POP_TEMPLATE_KNOBS["population_size"]] and len(winner) == 1,
            f"14c: trial {trial8['status']}, fits {fits8}, winner {winner}")
    clazz8 = load_model_class(pop8, "TorchCnnPopulation8")
    m8 = clazz8(**trial8["knobs"])
    m8.load_parameters(blob8)
    own8 = np.asarray(m8.predict(queries.tolist()))
    err8 = float(np.abs(served8 - own8).max())
    require(served8.shape == (8, CLASSES) and err8 <= ENSEMBLE_ATOL,
            f"/predict/cnnpop8 off its trial's own predict by {err8:.3g}")
    print(f"pop: 14c TorchCnnPopulation ({POP_TEMPLATE_KNOBS}) one trial "
          f"fitted {fits8['member_counts']} members in {pop8_s:.1f} s; "
          f"winner member {int(winner[0]['best_member'])} (validation "
          f"accuracy {winner[0]['best_val_accuracy']:.4f}, lr "
          f"{blob8['best_lr']:.2e}), test score {trial8['score']:.4f}; "
          f"served: /predict within {err8:.2e} of the trial's own predict; "
          f"card {card}", flush=True)
    return counts


def int8_phase(card: str) -> list:
    """14d: phase 8a's two BERT-base trials (its store, reopened) served
    under ``RAFIKI_SERVE_INT8=1``, solo and with ``ENSEMBLE_FUSED``.
    Returns each kernel's launches on this path."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.sdk import quant
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import trainer_cache_clear

    queries = BERT_RUN["queries"]
    eight = {"queries": queries[:8]}
    kernels = _kernels()
    source = (TEMPLATES / "torch_bert.py").read_text() + BERT_BASE
    clazz = load_model_class(source.encode(), "TorchBertBase")
    # a trainer cached by 8a and 12 serves bf16: cached_trainer does not
    # key on the switch (as in the JAX package)
    trainer_cache_clear()
    admin, server, new_client = _stack("text", "text.sqlite3", fresh=False)
    try:
        c = new_client()
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/sst2"
        trials = c.get_trials_of_train_job("sst2")
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        with _Env(RAFIKI_SERVE_INT8="1"):
            # ---- the main path's run (solo int8): counts from zero ----
            gc.collect()
            mem0 = torch.cuda.memory_allocated(0)
            for kernel in kernels:
                kernel.launches = 0
            t0 = time.perf_counter()
            inf = c.create_inference_job("sst2")
            deploy_s = time.perf_counter() - t0
            answers = np.asarray(c.predict("sst2", queries[:8]))
            lat = []
            for _ in range(INT8_TIMED):
                lat.append(_door_post(url, eight, token)[2])
            solo_counts = [k.launches for k in kernels]
            # ------------------------------------------------------------
            held = torch.cuda.memory_allocated(0) - mem0
            stats = c.get_inference_job_stats("sst2")
            c.stop_inference_job("sst2")
            trainer_cache_clear()
            # ---- the main path's run (fused int8): counts from zero ----
            for kernel in kernels:
                kernel.launches = 0
            t0 = time.perf_counter()
            finf = c.create_inference_job("sst2",
                                          budget={"ENSEMBLE_FUSED": 1})
            fdeploy_s = time.perf_counter() - t0
            fused = np.asarray(c.predict("sst2", queries[:8]))
            flat = []
            for _ in range(INT8_TIMED):
                flat.append(_door_post(url, eight, token)[2])
            fused_counts = [k.launches for k in kernels]
            # ------------------------------------------------------------
            fstats = c.get_inference_job_stats("sst2")
            c.stop_inference_job("sst2")
            trainer_cache_clear()
            # each trial's solo int8 answers against the fused stack's
            # answer for it, in this process on the card
            models = []
            for t, blob in zip(trials, blobs):
                m = clazz(**t["knobs"])
                m.load_parameters(blob)
                models.append(m)
            solo = [np.asarray(m.predict(queries[:8])) for m in models]
            qbytes = quant.quantized_bytes(
                quant.quantize_jax_layout(models[0]._model))
            n_params = sum(p.numel() for p in models[0]._model.parameters())
            stacked = models[0].ensemble_stack(models)
            require(stacked is not None, "the int8 trials did not fuse")
            per_model = np.asarray(stacked.predict_all(queries[:8]))
            del stacked, models, m
            # the same trials' int8 forward on the CPU
            trainer_cache_clear()
            set_device_grant(["cpu"])
            try:
                cpu = []
                for t, blob in zip(trials, blobs):
                    m = clazz(**t["knobs"])
                    m.load_parameters(blob)
                    ids = torch.from_numpy(
                        m._to_ids(queries[:INT8_CPU_ROWS]))
                    with torch.inference_mode():  # predict_fn's softmax
                        cpu.append(m._trainer._forward(
                            m._model, ids, None).double().numpy())
                    del m
            finally:
                set_device_grant(None)
                trainer_cache_clear()
    finally:
        server.stop()
        admin.shutdown()
    require(inf["status"] == "RUNNING" and len(inf["workers"]) == TRIALS,
            f"int8 job {inf['status']} with {len(inf['workers'])} workers")
    forwards = stats["batches"] + PREDICT_BUCKETS * TRIALS
    expect = [DEPTH * forwards, 0, 0, 0]
    require(solo_counts == expect,
            f"int8 launches {solo_counts}, expected {expect}")
    ffwd = fstats["batches"] + PREDICT_BUCKETS
    fexpect = [DEPTH * ffwd, 0, 0, 0]
    require(fused_counts == fexpect,
            f"fused int8 launches {fused_counts}, expected {fexpect}")
    require(answers.shape == fused.shape == (8, 2)
            and np.isfinite(answers).all() and np.isfinite(fused).all(),
            f"int8 /predict answered {answers.shape}, {fused.shape}")
    ref = BERT_RUN["batch8"]
    agree = float((answers.argmax(-1) == ref.argmax(-1)).mean())
    err_bf16 = float(np.abs(answers - ref).max())
    cpu_mean = sum(cpu) / len(cpu)
    err_cpu = float(np.abs(answers[:INT8_CPU_ROWS] - cpu_mean).max())
    err_bf16_rows = float(np.abs(answers[:INT8_CPU_ROWS]
                                 - ref[:INT8_CPU_ROWS]).max())
    p50, fp50 = (statistics.median(v) * 1e3 for v in (lat, flat))
    print(f"int8: 14d RAFIKI_SERVE_INT8=1: BERT-base's serving weights "
          f"{qbytes / 1e6:.1f} MB int8 with their scales (quantized_bytes) "
          f"against {n_params * 2 / 1e6:.1f} MB in bf16 and "
          f"{n_params * 4 / 1e6:.1f} MB f32 masters; the solo job's "
          f"{TRIALS} workers hold {held / 1e6:.1f} MB more on the card "
          f"after its requests (torch.cuda.memory_allocated; each keeps its "
          f"f32 masters and its int8 copy); solo job RUNNING in "
          f"{deploy_s:.1f} s ({TRIALS} workers), K1 launched "
          f"{solo_counts[0]} times in {forwards} bucketed forwards ({DEPTH} "
          f"a forward); p50 of 8 sentences on the admin door {p50:.2f} ms "
          f"against 8a's bf16 {BERT_RUN['p50_8']:.2f} ms and 12b's fused "
          f"bf16 {BERT_RUN.get('fused_p50_8', float('nan')):.2f} ms; "
          f"card {card}", flush=True)
    print(f"int8: the int8 answers against 8a's bf16 answers: argmax "
          f"agreement {agree:.3f} (>= {INT8_AGREE}), max |p - p_bf16| "
          f"{err_bf16:.3g} (<= {INT8_ATOL}); on the first {INT8_CPU_ROWS} "
          f"sentences against the same trials' int8 forward on the CPU "
          f"{err_cpu:.3g}, against bf16 {err_bf16_rows:.3g}", flush=True)
    require(agree >= INT8_AGREE and err_bf16 <= INT8_ATOL,
            f"int8 answers off 8a's bf16 answers: agreement {agree}, "
            f"max |dp| {err_bf16:.3g}")
    require(err_cpu <= err_bf16_rows,
            f"the card's int8 answers are further from the CPU's int8 "
            f"forward ({err_cpu:.3g}) than from bf16 ({err_bf16_rows:.3g})")
    ferr = float(np.abs(per_model - np.asarray(solo)).max())
    print(f"int8: ENSEMBLE_FUSED job RUNNING in {fdeploy_s:.1f} s (1 worker "
          f"holding {TRIALS} trials, fused_dispatch "
          f"{fstats['workers'][0].get('fused_dispatch')}); K1 launched "
          f"{fused_counts[0]} times in {ffwd} bucketed fused forwards "
          f"({DEPTH} a forward, not {DEPTH * TRIALS}); p50 of 8 sentences "
          f"{fp50:.2f} ms; each trial's answer in the fused int8 stack "
          f"against its solo int8 answer: max |dp| {ferr:.2e} "
          f"({'within' if ferr <= 1e-4 else 'past'} the JAX test's 1e-4), "
          + prob_check("fused int8 stack", per_model, np.asarray(solo))
          + "; /predict fused against solo: "
          + prob_check("fused int8 /predict/sst2", fused, answers)
          + f"; card {card}", flush=True)
    return [a + b for a, b in zip(solo_counts, fused_counts)]


def pop_datasets() -> tuple:
    """14's ``.npz`` sets under ``build/chip_smoke/pop/``: 11a's images
    (its generator and seed) scaled to [-1, 1] as float32, with their
    labels; (train uri, test uri, train images, train labels)."""
    from rafiki_tpu_torch.sdk.dataset import NumpyDataset, write_numpy_dataset

    out = WORK / "pop"
    out.mkdir(parents=True, exist_ok=True)
    uris, first = [], None
    for uri, split in zip(gan_datasets()[:2], ("train", "test")):
        ds = NumpyDataset(uri)
        x = ds.x.astype(np.float32) / 127.5 - 1.0
        if first is None:
            first = (x, ds.y.astype(np.int32))
        uris.append(write_numpy_dataset(x, ds.y.astype(np.int32),
                                        str(out / f"{split}.npz")))
    return uris[0], uris[1], first[0], first[1]


def population_int8_phase(card: str) -> tuple:
    """Phase 14: 14a-c populations, 14d int8 serving. Returns (each
    kernel's launches on the population paths, on the int8 path)."""
    t_phase = time.perf_counter()
    train_uri, test_uri, x, y = pop_datasets()
    print(f"pop: 11a's images ({GAN_IMAGES[0]} + {GAN_IMAGES[1]}, 32x32x3) "
          f"scaled to [-1, 1] and written as .npz in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    pop_step_gates(card, x, y)
    pop_cards_step(card, x, y)
    pop_epoch(card, x, y)
    t_a = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    pop_counts = pop_jobs(card, train_uri, test_uri, x)
    require(pop_counts == [0] * len(KERNEL_NAMES),
            f"the population paths launched attention kernels: {pop_counts}")
    t_bc = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8_counts = int8_phase(card)
    print(f"pop: 14a took {t_a:.0f} s, 14b-c {t_bc:.0f} s; int8: 14d took "
          f"{time.perf_counter() - t0:.0f} s; phase 14 took "
          f"{time.perf_counter() - t_phase:.0f} s", flush=True)
    return pop_counts, int8_counts


# ---------------------------------------------------------------------------
# phase 15: model-parallel training
# ---------------------------------------------------------------------------

MP_SEED = SEED + 50
MP_TIMED = 3  # AdamW steps timed a leg, after one untimed
# remat only recomputes: the loss as without it, and each leaf's update
# (its gradient, at lr 1) within 1e-3 of the gradient's norm (L2 over the
# leaf) plus the f32 rounding of the update (two ulps an element); a
# recompute that lost a tensor-parallel sum would be off by the size of
# the gradient
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_RTOL = 1e-3


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_tree(v, name))
        else:
            out[name] = np.asarray(v, np.float64)
    return out


def mp_expected(leg, axes: dict, steps: int = 1, remat: bool = False) -> list:
    """Each kernel's launches on a rank in ``steps`` of ``leg`` under
    ``axes``, in ``KERNEL_NAMES`` order: a layer's attention once forward
    (twice under remat) and once backward, every layer on every rank but
    under GPipe (a stage's layers, once a microbatch) and ring attention
    (no kernel)."""
    enc = leg.cfg.encoder
    if enc.seq_parallel == "ring" and axes.get("sp", 1) > 1:
        return [0, 0, 0, 0]
    per = enc.depth
    if enc.pipeline == "gpipe" and axes.get("pp", 1) > 1:
        per = enc.depth // axes["pp"] * enc.n_microbatches
    return [0, per * steps * (2 if remat else 1), per * steps, per * steps]


def mp_shapes(leg, axes: dict) -> list:
    """The attention shapes a rank's kernels see in ``leg``: (B, H, Sq,
    Skv, causal) a shape; none for ring attention over several ranks."""
    enc = leg.cfg.encoder
    dp, tp, sp = (axes.get(k, 1) for k in ("dp", "tp", "sp"))
    b = leg.batch[0].shape[0] // dp
    h = enc.heads // tp
    if leg.family == "vit":
        s = leg.cfg.seq_len
        return [(b, h, s // sp, s, False)]
    if enc.seq_parallel == "ring" and sp > 1:
        return []
    s = leg.batch[0].shape[1]
    if enc.pipeline == "gpipe" and axes.get("pp", 1) > 1:
        b //= enc.n_microbatches
    return [(b, h, s // sp, s, True)]


def rank_mp_kernels(shapes: list, seed: int) -> dict:
    """Rank side: K1-LSE, K2 and K3 (and K1) on this rank's card against
    their plain versions at each of ``shapes`` (bf16, Dh = 64); each
    error with its tolerance (phase 2's)."""
    from rafiki_tpu_torch.device import default_device

    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    dev = default_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    errs = {}
    for b, h, sq, skv, causal in shapes:
        q, dout = (torch.randn(b, h, sq, 64, generator=gen, device=dev,
                               dtype=bf16) for _ in range(2))
        k, v = (torch.randn(b, h, skv, 64, generator=gen, device=dev,
                            dtype=bf16) for _ in range(2))
        with torch.inference_mode():
            out = fa.flash_attention(q, k, v, causal=causal)
        o, lse, o32 = fa.flash_attention_lse(q, k, v, causal=causal)
        r_out, r_lse, r_o32 = fa.flash_attention_plain(q, k, v, causal,
                                                       return_lse=True)
        delta = fa._delta(r_o32, dout)
        dq, _ = fa.flash_attention_dq(q, k, v, dout, r_lse, r_o32, causal)
        dk, dv = fa.flash_attention_dkv(q, k, v, dout, r_lse, delta, causal)
        torch.cuda.synchronize(dev)
        r_dq = fa.flash_attention_dq_plain(q, k, v, dout, r_lse, delta,
                                           causal)
        r_dk, r_dv = fa.flash_attention_dkv_plain(q, k, v, dout, r_lse,
                                                  delta, causal)
        tag = f"B={b} H={h} Sq={sq} Skv={skv}{' causal' if causal else ''}"
        # a causal row that sees a key or two outputs ~|v|: its error
        # over max(1, |ref|), as phase 2's causal cases (_out_err)
        errs[tag] = {
            "K1": (_out_err(out, r_out, causal)[0], TOL[bf16]),
            "K1-LSE out": (max(_out_err(o, r_out, causal)[0],
                               _out_err(o32, r_o32, causal)[0]),
                           TOL[bf16]),
            "K1-LSE lse": (float((lse - r_lse).abs().max()), LSE_TOL[bf16]),
            "K2 dq": (_rel_err(dq, r_dq), TOL[bf16]),
            "K3 dk": (_rel_err(dk, r_dk), TOL[bf16]),
            "K3 dv": (_rel_err(dv, r_dv), TOL[bf16])}
        del q, k, v, dout, out, o, lse, o32, r_out, r_lse, r_o32
    return {"device": str(dev), "errs": errs}


@contextlib.contextmanager
def _f32_compute():
    """The ViT and the LM computing in f32 (images not cast to bf16, the
    embedding in f32): the reference a bf16 step's rounding is measured
    against."""
    from rafiki_tpu_torch.models import core

    cast, emb = core.cast_for_compute, core.embedding
    core.cast_for_compute = lambda x, dtype=None: x
    core.embedding = lambda p, ids, dtype=None: emb(p, ids, torch.float32)
    try:
        yield
    finally:
        core.cast_for_compute, core.embedding = cast, emb


def _sgd_step(leg, groups, tree: dict) -> tuple:
    """(loss, the whole updated tree as float64 leaves) of one SGD step
    at lr 1 from ``tree``: each leaf less its gradient."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.parallel import dryrun

    trainer = dryrun.trainer_for(leg, groups, lambda ps: torch.optim.SGD(
        ps, lr=1.0))
    params, opt = trainer.init(lambda rng: tree)
    params, opt, loss, _ = trainer.step(params, opt, leg.batch,
                                        np.array([0, leg.key], np.uint32))
    whole = convert.gather_tree(params, trainer.param_specs, groups)
    return float(loss), _flat_tree(whole)


def _timed_steps(leg, groups, tree: dict) -> float:
    """Median ms a step (host clock, a call to its synchronise) of
    MP_TIMED AdamW steps (the dryrun's optimizer) after one untimed. A
    step waits on the card for its loss, so a span of CUDA events around
    the steps would hold the host's time too: none is reported."""
    from rafiki_tpu_torch.parallel import dryrun

    trainer = dryrun.trainer_for(leg, groups)
    params, opt = trainer.init(lambda rng: tree)
    dev = groups.device
    key = np.array([0, leg.key], np.uint32)
    trainer.step(params, opt, leg.batch, key)
    torch.cuda.synchronize(dev)
    calls = []
    for _ in range(MP_TIMED):
        t = time.perf_counter()
        trainer.step(params, opt, leg.batch, key)
        torch.cuda.synchronize(dev)
        calls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(calls)


def rank_mp(devices: list, seed: int) -> dict:
    """Rank side of 15b. For each training leg of the full-width dryrun:
    rank 0 first takes on one card (the others waiting in the group) one
    SGD step at lr 1 in bf16 and one in f32 and times the leg's AdamW
    step; then every rank the n-card bf16 SGD step and the timed AdamW
    steps. Then leg 1 at ``remat="dots"`` and ``"full"``, the n-card SGD
    step again from the same tree, batch and key, with its launches and
    its distance from the step without remat; and each kernel against
    its plain version at every leg's shapes."""
    from rafiki_tpu_torch.parallel import dryrun, ranks
    from rafiki_tpu_torch.parallel.collectives import MeshGroups
    from rafiki_tpu_torch.parallel.sharding import make_train_mesh

    world = ranks.current_group()
    n, first = len(devices), world.rank == 0
    out = {"rank": world.rank, "legs": [], "remat": []}
    shapes = []
    for leg in dryrun.legs(n, full=True, seed=seed):
        tree = dryrun.init_fn(leg)(np.random.default_rng(seed))
        rec = {"name": leg.name, "axes": leg.axes}
        shapes += [s for s in mp_shapes(leg, leg.axes) if s not in shapes]
        if first and n > 1:
            with ranks.alone():
                one = MeshGroups.create(make_train_mesh(
                    devices=[str(world.device)]), None)
                rec["one"] = _sgd_step(leg, one, tree)
                with _f32_compute():
                    rec["f32"] = _sgd_step(leg, one, tree)
                rec["one_ms"] = _timed_steps(leg, one, tree)
                gc.collect()
                torch.cuda.empty_cache()
        world.all_reduce_(torch.zeros(1, device=world.device))  # wait here
        groups = dryrun.mesh_groups(leg, devices)
        try:
            ranks.reset_launches()
            rec["many"] = _sgd_step(leg, groups, tree)
            rec["launches"] = ranks.launch_counts()
            rec["ms"] = _timed_steps(leg, groups, tree)
        finally:
            groups.close()
        if not out["legs"]:
            base, base_tree = rec["many"], tree
        if not first:
            rec.pop("many")
        out["legs"].append(rec)
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    leg = dryrun.legs(n, full=True, seed=seed)[0]
    start = _flat_tree(base_tree)
    for remat in ("dots", "full"):
        rleg = dataclasses.replace(leg, cfg=dataclasses.replace(
            leg.cfg, encoder=dataclasses.replace(leg.cfg.encoder,
                                                 remat=remat)))
        groups = dryrun.mesh_groups(rleg, devices)
        try:
            ranks.reset_launches()
            loss, whole = _sgd_step(rleg, groups, base_tree)
            launches = ranks.launch_counts()
        finally:
            groups.close()
        # each leaf holds its start less its gradient: (distance from
        # the step without remat, the gradient's norm, the tolerance)
        errs = {}
        for k in start:
            d = np.linalg.norm(whole[k] - base[1][k])
            g = np.linalg.norm(start[k] - base[1][k])
            ulps = np.linalg.norm(np.spacing(base[1][k].astype(np.float32)))
            errs[k] = (float(d), float(g),
                       float(REMAT_GRAD_RTOL * g + 2 * ulps))
        worst = max(errs, key=lambda k: errs[k][0] / errs[k][2])
        out["remat"].append({"remat": remat, "loss": loss,
                             "base_loss": base[0], "launches": launches,
                             "worst": worst, "grad_err": errs[worst]})
        del whole
    del base, base_tree, start
    out["kernels"] = rank_mp_kernels(shapes, seed)
    return out


def _mp_gates(rec: dict, n: int) -> None:
    """15b's comparison of one leg on rank 0: the n-card bf16 step
    against one card's, each measured against the one-card f32 step.
    The loss within CARDS_LOSS_RTOL of one card's, or within 1.5 times
    one card's distance from f32, whichever is larger; each leaf's
    update (its gradient) no farther from f32 than BF16_GRAD_RATIO times
    one card's bf16 update is (the bf16 steps round at other places on n
    cards: the tensor-parallel sums, the sequence shards, ring attention
    in f32 against the kernels)."""
    loss_1, one = rec["one"]
    loss_32, f32 = rec["f32"]
    loss_n, many = rec["many"]
    label = f"{rec['name']} {_axes_str(rec['axes'])}"
    tol = max(CARDS_LOSS_RTOL * abs(loss_1), 1.5 * abs(loss_1 - loss_32))
    errs = {}
    for k in f32:
        # each tree holds the leaf less its gradient, from the same start
        errs[k] = (np.linalg.norm(many[k] - f32[k]),
                   np.linalg.norm(one[k] - f32[k]),
                   np.linalg.norm(many[k] - one[k]))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    print(f"model parallel: {label}: the {n}-card bf16 step against one "
          f"card's: loss {loss_n:.6f} vs {loss_1:.6f} (f32 {loss_32:.6f}; "
          f"|diff| {abs(loss_n - loss_1):.3g}, tol {tol:.3g}); each leaf's "
          f"distance from the f32 step, {n} cards / one card (ratio; tol "
          f"{BF16_GRAD_RATIO:g}): " + ", ".join(
              f"{k} {en:.3g}/{e1:.3g}"
              f" ({en / max(e1, 1e-30):.2f})"
              for k, (en, e1, _) in sorted(errs.items()))
          + f"; worst ratio {worst}", flush=True)
    require(abs(loss_n - loss_1) <= tol, f"{label}: the n-card loss differs")
    for k, (en, e1, direct) in errs.items():
        require(en <= BF16_GRAD_RATIO * e1 or direct == 0.0,
                f"{label}: {k} {en:.3g} from f32 on {n} "
                f"cards, {en / max(e1, 1e-30):.3g} times one card's {e1:.3g}")


def _axes_str(axes: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in axes.items())


def model_parallel_phase(card: str) -> list:
    """Phase 15; each kernel's launches on the dryrun's main path (15a),
    summed over the ranks and legs, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel import dryrun, ranks

    t_phase = time.perf_counter()
    n = min(torch.cuda.device_count(), MAX_CARDS)
    print(f"model parallel: n = {n} of {torch.cuda.device_count()} visible "
          f"card{'s' if torch.cuda.device_count() > 1 else ''}"
          + ("" if n > 1 else ": one card, so every leg runs on a mesh of "
             "one (MoE, remat and the trainer at full width) and no "
             "several-card result is claimed from this run"), flush=True)
    legs = dryrun.legs(n, full=True, seed=MP_SEED)

    # ---- 15a: the entry point a user calls, at full width ----
    ranks.reset_launches()
    t0 = time.perf_counter()
    records = dryrun.dryrun_multichip(n, device="cuda", full=True,
                                      seed=MP_SEED)
    dry_s = time.perf_counter() - t0
    totals = [0, 0, 0, 0]
    for r, rank_recs in enumerate(records):
        for leg, rec in zip(legs + [None], rank_recs):
            got = [rec["launches"][k] for k in COUNTERS]
            totals = [a + b for a, b in zip(totals, got)]
            if leg is None:
                want = [DEPTH, 0, 0, 0]
                what = "serve-predict"
            else:
                want = mp_expected(leg, leg.axes, leg.steps)
                what = leg.name
            require(got == want, f"rank {r} launched {got} in {what}, "
                    f"expected {want}")
    print(f"model parallel: dryrun_multichip({n}, full width) in "
          f"{dry_s:.1f} s; every rank launched, a leg: " + "; ".join(
              f"{rec['name']} {[rec['launches'][k] for k in COUNTERS]}"
              for rec in records[0]) + " (K1, K1-LSE, K2, K3)", flush=True)

    # ---- 15b: n cards against one, remat, the kernels at every shape ----
    devices = [f"cuda:{i}" for i in range(n)]
    set_device_grant(devices)
    try:
        with ranks.Ranks(devices) as r:
            ranks.set_group(r.group)
            try:
                recs = r.run(rank_mp, devices, MP_SEED)
            finally:
                ranks.set_group(None)
    finally:
        set_device_grant(None)
    for i, leg in enumerate(legs):
        rec0 = recs[0]["legs"][i]
        if n > 1:
            _mp_gates(rec0, n)
        for rec in (x["legs"][i] for x in recs):
            got = [rec["launches"][k] for k in COUNTERS]
            want = mp_expected(leg, leg.axes)
            require(got == want, f"{leg.name}: a rank launched {got} in the "
                    f"compared step, expected {want}")
        one_call = rec0["one_ms"] if n > 1 else rec0["ms"]
        print(f"model parallel: {leg.name} {_axes_str(leg.axes)}: AdamW "
              f"step (median of {MP_TIMED}, host clock a call) on 1 card "
              f"{one_call:.2f} ms"
              + ("" if n == 1 else f"; on {n} cards " + ", ".join(
                  f"rank {x['rank']} {x['legs'][i]['ms']:.2f}"
                  for x in recs) + " ms") + f"; card {card}", flush=True)
    for x in recs:
        for rr in x["remat"]:
            got = [rr["launches"][k] for k in COUNTERS]
            want = mp_expected(legs[0], legs[0].axes, remat=True)
            require(got == want, f"rank {x['rank']} remat={rr['remat']} "
                    f"launched {got}, expected {want}")
            what = f"rank {x['rank']} remat={rr['remat']}"
            d, g, tol = rr["grad_err"]
            print(f"model parallel: ViT-B/16 {_axes_str(legs[0].axes)} at "
                  f"{what}, the SGD step against the one without remat: "
                  f"loss {rr['loss']:.6f} vs {rr['base_loss']:.6f} (|diff| "
                  f"{abs(rr['loss'] - rr['base_loss']):.3g}, tol "
                  f"{REMAT_LOSS_RTOL:g} relative); worst leaf "
                  f"{rr['worst']}: its update {d:.3g} from the one without "
                  f"remat, {d / max(g, 1e-30):.3g} of its gradient's norm "
                  f"{g:.3g} (tol {tol:.3g}: {REMAT_GRAD_RTOL:g} of the "
                  f"norm and two f32 ulps an element); launches {got}",
                  flush=True)
            require(abs(rr["loss"] - rr["base_loss"])
                    <= REMAT_LOSS_RTOL * abs(rr["base_loss"]),
                    f"{what}: the loss differs from the step without remat")
            require(d <= tol,
                    f"{what}: {rr['worst']}'s gradient differs from the "
                    f"step without remat")
    for x in recs:
        k = x["kernels"]
        for shape, errs in k["errs"].items():
            line = ", ".join(f"{name} {e:.3g} (tol {tol:g})"
                             for name, (e, tol) in errs.items())
            print(f"model parallel: kernels against their plain versions "
                  f"on {k['device']} at {shape}: {line}", flush=True)
            require(all(e <= tol for e, tol in errs.values()),
                    f"a kernel disagrees on {k['device']} at {shape}")
    print(f"model parallel: phase 15 in {time.perf_counter() - t_phase:.0f}"
          f" s", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 16: fleet operations (rollout, autoscaler, warm pool, arbiter)
# ---------------------------------------------------------------------------

#: 16a: requests of 8 sentences timed sequentially before and after the
#: rollout, and the judge's knobs (a short window, few requests)
FLEET_TIMED = 10
FLEET_JUDGE = {"RAFIKI_ROLLOUT_JUDGE_WINDOW_S": "2",
               "RAFIKI_ROLLOUT_MIN_REQUESTS": "3"}
#: 16b: the loop's knobs (short interval, window and cooldowns; a
#: shed-driven flood past a door cap of 2, bounded by 2 replicas)
FLEET_SCALER = {"RAFIKI_AUTOSCALE": "1",
                "RAFIKI_AUTOSCALE_INTERVAL_S": "0.25",
                "RAFIKI_AUTOSCALE_WINDOW_S": "3",
                "RAFIKI_AUTOSCALE_SHED_THRESHOLD": "2",
                "RAFIKI_AUTOSCALE_DEPTH_HIGH": "1000",
                "RAFIKI_AUTOSCALE_DEPTH_LOW": "1",
                "RAFIKI_AUTOSCALE_MIN_REPLICAS": "1",
                "RAFIKI_AUTOSCALE_MAX_REPLICAS": "2",
                "RAFIKI_AUTOSCALE_COOLDOWN_UP_S": "0.5",
                "RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S": "1",
                "RAFIKI_AUTOSCALE_DRAIN_S": "10"}
FLOOD_CLIENTS, FLOOD_CAP = 8, 2
#: 16d: the small image set of phase 7a, for the train job that reclaims
FLEET_FF = ("torch_feedforward", "TorchFeedForward")


@contextlib.contextmanager
def _fleet_sizing(best_trials: int, replicas: int):
    """The deploy's sizing settings (read at import, so set on the
    module), restored after."""
    from rafiki_tpu_torch import config

    saved = (config.INFERENCE_MAX_BEST_TRIALS,
             config.INFERENCE_WORKER_REPLICAS_PER_TRIAL)
    config.INFERENCE_MAX_BEST_TRIALS = best_trials
    config.INFERENCE_WORKER_REPLICAS_PER_TRIAL = replicas
    try:
        yield
    finally:
        (config.INFERENCE_MAX_BEST_TRIALS,
         config.INFERENCE_WORKER_REPLICAS_PER_TRIAL) = saved


class _Steady:
    """A client thread sending requests of 8 sentences to a door, one at
    a time: each one's time and status."""

    def __init__(self, url: str, body: dict, token: str):
        self.lat, self.failed = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(url, body, token), daemon=True)
        self._thread.start()

    def _run(self, url, body, token):
        while not self._stop.is_set():
            status, _, secs, raw = _door_post(url, body, token)
            if status == 200:
                got = np.asarray(json.loads(raw)["data"]["predictions"])
                if got.shape == (8, 2) and np.isfinite(got).all():
                    self.lat.append((time.perf_counter(), secs))
                    continue
            self.failed.append((status, raw[:200]))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(120)
        require(not self._thread.is_alive(), "the load thread hung")


def _answers(c, queries) -> np.ndarray:
    got = np.asarray(c.predict("sst2", queries[:8]))
    require(got.shape == (8, 2) and np.isfinite(got).all(),
            f"/predict/sst2 answered {got.shape}")
    return got


def _deploy_s(admin, sid: str, until: float) -> float:
    """A replica's deploy time: its service row's creation to ``until``
    (the event that routed it)."""
    return until - admin.db.get_service(sid)["datetime_started"]


def fleet_rollout(card: str, admin, c, token: str, inf: dict,
                  port: int) -> dict:
    """16a: the job (one trial, one replica) moved to 8a's other trial
    under a steady stream of 8-sentence requests; then a second update
    with the ``deploy`` chaos site armed. Returns what 16b-c use."""
    from rafiki_tpu_torch.client.client import RolloutInFlightError
    from rafiki_tpu_torch.predictor import result_cache
    from rafiki_tpu_torch.utils import chaos
    from rafiki_tpu_torch.worker.inference import serving_stats

    queries = BERT_RUN["queries"]
    eight = {"queries": queries[:8]}
    admin_url = f"http://127.0.0.1:{port}/predict/sst2"
    (w0,) = inf["workers"]
    incumbent = w0["trial_id"]
    target = next(t for t in BERT_RUN["own_by_trial"] if t != incumbent)
    before = [_door_post(admin_url, eight, token) for _ in range(FLEET_TIMED)]
    require(all(r[0] == 200 for r in before), "a request before the "
            f"rollout failed: {[r[0] for r in before]}")
    # version-0 entries in the result cache, which DONE must flush
    with _Env(RAFIKI_PREDICT_CACHE="1"):
        c.predict("sst2", queries[:8])
    cache = result_cache.get_cache()
    v0 = sum(1 for k in list(cache._entries) if k[:2] == (inf["id"], 0))
    require(v0 == 8, f"{v0} version-0 cache entries, expected 8")
    with _Env(**FLEET_JUDGE):
        load = _Steady(admin_url, eight, token)
        time.sleep(1.0)  # incumbent samples for the judge
        t0 = time.perf_counter()
        row = c.update_inference_job("sst2", target, canary_fraction=0.5)
        require(row["phase"] == "CANARY" and row["to_version"] == 1,
                f"update answered {row}")
        try:
            c.update_inference_job("sst2", target)
            conflict = None
        except RolloutInFlightError as e:
            conflict = e.status
        require(conflict == 409, f"a second update during a live rollout "
                f"answered {conflict}, not 409")
        done = c.wait_until_rollout_done("sst2", timeout_s=300)
        rollout_s = time.perf_counter() - t0
        t_done = time.perf_counter()
        time.sleep(0.5)
        load.stop()
    require(not load.failed, f"{len(load.failed)} requests failed during "
            f"the rollout: {load.failed[:3]}")
    live = admin.services.live_inference_workers(inf["id"])
    require([(w["trial_id"], w["model_version"]) for w in live]
            == [(target, 1)], f"after DONE the fleet is {live}")
    predictor = admin.services.get_predictor(inf["id"])
    require(predictor.serving_version() == 1,
            f"serving version {predictor.serving_version()} after DONE")
    left = [k for k in list(cache._entries)
            if k[0] == inf["id"] and k[1] != 1]
    require(not left, f"{len(left)} cache entries of the old version left")
    events = {e["event"]: e for e in done["events"]}
    canary_sid = live[0]["service_id"]
    canary_s = _deploy_s(admin, canary_sid, events["canary_deployed"]["ts"])
    kernels = _kernels()
    k1 = kernels[0].launches
    b0 = serving_stats().get(canary_sid, {}).get("batches", 0)
    after_answers = _answers(c, queries)
    k1_new = kernels[0].launches - k1
    batches = serving_stats()[canary_sid]["batches"] - b0
    require(batches > 0 and k1_new == DEPTH * batches,
            f"the new-version replica ran {batches} batches and K1 "
            f"{k1_new} times (expected {DEPTH} a batch)")
    check = prob_check("16a after DONE", after_answers,
                       BERT_RUN["own_by_trial"][target])
    after = [_door_post(admin_url, eight, token) for _ in range(FLEET_TIMED)]
    require(all(r[0] == 200 for r in after), "a request after the rollout "
            "failed")
    during = [s for t, s in load.lat if t <= t_done]
    p50 = [statistics.median(v) * 1e3 for v in (
        [r[2] for r in before], during, [r[2] for r in after])]
    print(f"fleet: 16a rollout of sst2 from trial {incumbent[:8]} (v0) to "
          f"{target[:8]} (v1) under a steady stream of 8-sentence requests "
          f"({len(load.lat)} answered, {len(load.failed)} failed): DONE in "
          f"{rollout_s:.2f} s (update to DONE; events "
          f"{[e['event'] for e in done['events']]}); the canary deployed "
          f"in {canary_s:.2f} s (service row to routed, warm-up included); "
          f"a second update while it was live answered {conflict}; serving "
          f"version 1, {v0} cache entries of version 0 flushed, none left; "
          f"p50 of 8 sentences before {p50[0]:.2f} ms, during {p50[1]:.2f} "
          f"ms, after {p50[2]:.2f} ms; the new replica ran K1 {k1_new} "
          f"times in {batches} batch(es); card {card}", flush=True)
    print(f"fleet: 16a answers after DONE against trial {target[:8]}'s own "
          f"(8a): {check}", flush=True)
    # the second update, back to the first trial, its canary's placement
    # failed by the deploy chaos site
    load = _Steady(admin_url, eight, token)
    try:
        chaos.install([chaos.ChaosRule(site=chaos.SITE_DEPLOY,
                                       action=chaos.ACTION_ERROR,
                                       match=incumbent)])
        with _Env(**FLEET_JUDGE):
            c.update_inference_job("sst2", incumbent)
            rb = None
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                rb = c.get_rollout("sst2")
                if rb["phase"] not in ("CANARY", "ROLLING"):
                    break
                time.sleep(0.05)
    finally:
        chaos.clear()
        time.sleep(0.5)
        load.stop()
    require(rb["phase"] == "ROLLED_BACK" and "deploy" in (rb["reason"] or ""),
            f"the chaos update ended {rb['phase']}: {rb['reason']}")
    require(not load.failed, f"{len(load.failed)} requests failed during "
            f"the rolled-back update: {load.failed[:3]}")
    require([(w["trial_id"], w["model_version"]) for w in
             admin.services.live_inference_workers(inf["id"])]
            == [(target, 1)], "the rollback changed the fleet")
    check = prob_check("16a after the rollback", _answers(c, queries),
                       BERT_RUN["own_by_trial"][target])
    print(f"fleet: 16a a second update (to {incumbent[:8]}) with the deploy "
          f"chaos site armed: {rb['phase']} ({rb['reason']}); "
          f"{len(load.lat)} requests answered, none failed; the answers "
          f"stay the incumbent's: {check}", flush=True)
    return {"target": target, "canary_s": canary_s, "rollout_s": rollout_s,
            "p50": p50}


def fleet_phase(card: str) -> list:
    """Phase 16 on phase 8a's two trained BERT-base trials (its store): 16a
    a live rollout and a rolled-back one; 16b the autoscaler, a flood up
    and idle back down; 16c the warm pool, a standby warmed, a replica
    killed under load and replaced, the pool topped up; 16d on two or more
    cards only. Returns each kernel's launches on this path."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.worker.inference import serving_stats

    t_phase = time.perf_counter()
    queries = BERT_RUN["queries"]
    eight = {"queries": queries[:8]}
    kernels = _kernels()
    admin, server, new_client = _stack("text", "text.sqlite3", fresh=False)
    try:
        c = new_client()
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        # ---- the main path's run (16a-c): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        with _fleet_sizing(1, 1), _Env(RAFIKI_PREDICTOR_PORTS="1"):
            inf = c.create_inference_job("sst2")
        deploy_s = time.perf_counter() - t0
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == 1,
                f"inference job {inf['status']} with {inf['workers']}")
        print(f"fleet: sst2 deployed serving its best trial "
              f"(INFERENCE_MAX_BEST_TRIALS=1) on "
              f"{inf['workers'][0]['chips']} in {deploy_s:.2f} s; card "
              f"{card}", flush=True)
        fleet_rollout(card, admin, c, token, inf, server.port)
        t_a = time.perf_counter()
        # ---- 16b up: a flood past the job's door cap ----
        door = f"http://{inf['predictor_host']}:{inf['predictor_port']}" \
               f"/predict"
        scaler = admin.autoscaler
        with _Env(**FLEET_SCALER):
            scaler.start()
            statuses, stop = [], threading.Event()

            def flood():
                while not stop.is_set():
                    statuses.append(_door_post(door, eight, token)[0])

            with _Env(RAFIKI_PREDICT_MAX_INFLIGHT=str(FLOOD_CAP)):
                threads = [threading.Thread(target=flood)
                           for _ in range(FLOOD_CLIENTS)]
                for th in threads:
                    th.start()
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and not any(
                        e["action"] == "scale_up" for e in scaler.events):
                    time.sleep(0.05)
                stop.set()
                for th in threads:
                    th.join(60)
            scaler.stop()
        ups = [e for e in scaler.events if e["action"] == "scale_up"]
        require(len(ups) == 1 and ups[0]["result"].get("added"),
                f"the flood's scale-up: {ups}")
        up = ups[0]
        (added,) = up["result"]["added"]
        live = admin.services.live_inference_workers(inf["id"])
        require(len(live) == 2 == int(FLEET_SCALER[
            "RAFIKI_AUTOSCALE_MAX_REPLICAS"]), f"{len(live)} replicas")
        require(set(statuses) <= {200, 503, 429} and 200 in statuses
                and 503 in statuses, f"flood statuses {sorted(set(statuses))}")
        new_chips = admin.db.get_service(added)["chips"]
        on_one = torch.cuda.device_count() == 1
        require(not on_one or (new_chips == [0]
                               and up["result"]["borrowed_chips"] == 0),
                f"on one card the new replica is on {new_chips}, borrowed "
                f"{up['result']['borrowed_chips']}")
        require(up["reason"] == "sustained shed" and {
            "shed_in_window", "mean_backlog", "max_backlog", "replicas"}
            <= set(up["signals"]), f"the scale-up event {up}")
        up_s = _deploy_s(admin, added, up["ts"])
        print(f"fleet: 16b a flood of {FLOOD_CLIENTS} clients on the job's "
              f"door at RAFIKI_PREDICT_MAX_INFLIGHT={FLOOD_CAP}: "
              f"{statuses.count(200)} answered, {statuses.count(503)} shed "
              f"503, {statuses.count(429)} shed 429; the loop scaled up by "
              f"1 ({up['reason']}; signals {up['signals']}) to 2 replicas "
              f"(MAX_REPLICAS 2), the new one deployed in {up_s:.2f} s on "
              f"{new_chips} (borrowed {up['result']['borrowed_chips']}: "
              f"{'one card, the floor of 1 lends none, so it shares the card' if on_one else 'above the floor'}"
              f"); card {card}", flush=True)
        t_b = time.perf_counter()
        # ---- 16c the warm pool ----
        pool = admin.warm_pool
        with _Env(RAFIKI_AUTOSCALE_WARM_POOL="1"):
            k1 = kernels[0].launches
            t0 = time.perf_counter()
            placed = pool.tick()
            standby_s = time.perf_counter() - t0
            warm_k1 = kernels[0].launches - k1
            require([a["action"] for a in placed] == ["place"],
                     f"the pool's tick: {placed}")
            stby = placed[0]["service_id"]
            require(warm_k1 >= DEPTH * PREDICT_BUCKETS,
                    f"the standby's warm-up launched K1 {warm_k1} times "
                    f"(expected {DEPTH} x {PREDICT_BUCKETS} buckets)")
            for _ in range(4):
                require(_door_post(door, eight, token)[0] == 200,
                        "a request beside the standby failed")
            require(serving_stats().get(stby, {}).get("queries", 0) == 0,
                    "the standby was routed")
            load = _Steady(door, eight, token)
            time.sleep(1.0)
            victim = next(w["service_id"] for w in
                          admin.services.live_inference_workers(inf["id"])
                          if w["service_id"] != added)
            t_kill = time.perf_counter()
            admin.placement.destroy_service(victim)  # the replica dies
            admin._on_service_status(victim, "ERRORED")
            promote_s = time.perf_counter() - t_kill
            time.sleep(1.0)
            load.stop()
            live = [w["service_id"] for w in
                    admin.services.live_inference_workers(inf["id"])]
            require(stby in live and victim not in live,
                    f"after the kill the fleet is {live}")
            require(not load.failed, f"{len(load.failed)} client errors "
                    f"after the kill: {load.failed[:3]}")
            require(serving_stats()[stby]["queries"] > 0,
                    "the promoted standby took no request")
            t0 = time.perf_counter()
            topped = pool.tick()
            topup_s = time.perf_counter() - t0
            require([a["action"] for a in topped] == ["place"],
                    f"the next tick: {topped}")
            require(admin.db.get_inference_job(inf["id"])["status"]
                    == "RUNNING", "the job left RUNNING")
        print(f"fleet: 16c RAFIKI_AUTOSCALE_WARM_POOL=1: a standby placed "
              f"and warmed in {standby_s:.2f} s (K1 {warm_k1} launches in "
              f"its warm-up), never routed; a routed replica killed under a "
              f"steady stream ({len(load.lat)} answered, "
              f"{len(load.failed)} failed): the standby promoted "
              f"{promote_s * 1e3:.1f} ms after the kill (the worker's stop "
              f"and the ERRORED verdict included); the next tick placed a "
              f"new standby in {topup_s:.2f} s; events "
              f"{[e['action'] for e in pool.events]}; card {card}",
              flush=True)
        t_c = time.perf_counter()
        # ---- 16b down: idle drains back to MIN_REPLICAS ----
        with _Env(**FLEET_SCALER):
            scaler.start()
            answered, failed = 0, []
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not any(
                    e["action"] == "scale_down" for e in scaler.events):
                status = _door_post(door, eight, token)[0]
                if status == 200:
                    answered += 1
                else:
                    failed.append(status)
                time.sleep(0.2)
            scaler.stop()
        downs = [e for e in scaler.events if e["action"] == "scale_down"]
        require(downs and downs[0]["result"].get("removed"),
                f"no scale-down: {downs}")
        require(not failed, f"requests failed while draining: {failed}")
        live = admin.services.live_inference_workers(inf["id"])
        require(len(live) == 1, f"{len(live)} replicas after the drain")
        require(downs[0]["reason"] == "sustained idle"
                and "replicas" in downs[0]["signals"],
                f"the scale-down event {downs[0]}")
        report = scaler.report()
        print(f"fleet: 16b idle: the loop drained back to MIN_REPLICAS 1 "
              f"({downs[0]['reason']}; signals {downs[0]['signals']}); "
              f"{answered} requests sent while it drained, all answered; "
              f"the loan book {report['chip_budget']}; card {card}",
              flush=True)
        fleet_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        c.stop_inference_job("sst2")
    finally:
        server.stop()
        admin.shutdown()
    require(fleet_counts[0] > 0 and fleet_counts[1:] == [0, 0, 0],
            f"fleet launches {fleet_counts}")
    t_end = time.perf_counter()
    print(f"fleet: 16a took {t_a - t_phase:.0f} s, 16b {t_b - t_a + t_end - t_c:.0f}"
          f" s, 16c {t_c - t_b:.0f} s; phase 16 took {t_end - t_phase:.0f} s "
          f"(K1 {fleet_counts[0]} launches); card {card}", flush=True)
    if torch.cuda.device_count() < 2:
        print("fleet: 16d (a borrow above the training floor and its "
              "reclaim; generation on a CHIPS_PER_WORKER=2 grant) needs two "
              "cards: skipped on one", flush=True)
    else:
        fleet_cards(card)
    return fleet_counts


def fleet_cards(card: str) -> None:
    """16d, on two or more cards: a scale-up borrows an idle card above
    ``RAFIKI_AUTOSCALE_TRAIN_FLOOR`` (an exclusive grant), and a train job
    that cannot allocate its cards reclaims it; 8b's LM served under
    ``CHIPS_PER_WORKER=2`` streams what it streamed on one card, from the
    grant's first card."""
    n = torch.cuda.device_count()
    # the floor of 1 leaves nothing to lend on two cards (one serves)
    floor = str(min(1, n - 2))
    admin, server, new_client = _stack("text", "text.sqlite3", fresh=False)
    try:
        c = new_client()
        with _fleet_sizing(1, 1):
            inf = c.create_inference_job("sst2")
        free0 = admin.placement.allocator.free_chips
        t0 = time.perf_counter()
        with _Env(RAFIKI_AUTOSCALE_TRAIN_FLOOR=floor):
            out = c.scale_inference_job("sst2", 1)
        up_s = time.perf_counter() - t0
        (borrowed,) = out["added"]
        chips = admin.db.get_service(borrowed)["chips"]
        require(out["borrowed_chips"] == 1 and len(chips) == 1
                and chips != inf["workers"][0]["chips"]
                and admin.chip_arbiter.borrowed_chips() == 1
                and admin.placement.allocator.free_chips == free0 - 1,
                f"the scale-up on {n} cards: {out}, chips {chips}")
        train_uri, test_uri, _ = zoo_datasets("small", ZOO_SMALL, SEED + 70)
        name, cls = FLEET_FF
        c.create_model("ff", "IMAGE_CLASSIFICATION",
                       (TEMPLATES / f"{name}.py").read_bytes(), cls)
        want = admin.placement.allocator.free_chips + 1
        t0 = time.perf_counter()
        c.create_train_job("ff", "IMAGE_CLASSIFICATION", train_uri, test_uri,
                           budget={"MODEL_TRIAL_COUNT": want,
                                   "CHIP_COUNT": want})
        reclaim_s = time.perf_counter() - t0
        live = [w["service_id"] for w in
                admin.services.live_inference_workers(inf["id"])]
        require(admin.chip_arbiter.borrowed_chips() == 0
                and borrowed not in live and len(live) == 1,
                f"after the train job: loans "
                f"{admin.chip_arbiter.borrowed()}, live {live}")
        job = c.wait_until_train_job_stopped("ff", timeout_s=600)
        require(job["status"] == "STOPPED" and sorted(
            ch for w in job["workers"] for ch in w["chips"])
            == sorted(set(range(n)) - set(inf["workers"][0]["chips"])),
            f"the train job {job['status']} on "
            f"{[w['chips'] for w in job['workers']]}")
        _answers(c, BERT_RUN["queries"])
        c.stop_inference_job("sst2")
        print(f"fleet: 16d on {n} cards: a scale-up borrowed card {chips} "
              f"above the floor of {floor} ({up_s:.2f} s); a train job of "
              f"{want} "
              f"one-card trials then reclaimed it ({reclaim_s:.2f} s to "
              f"its services; the borrowed replica drained, the loan "
              f"returned) and ran on {[w['chips'] for w in job['workers']]}"
              f"; the job kept serving; card {card}", flush=True)
    finally:
        server.stop()
        admin.shutdown()
    admin, server, new_client = _stack("lm", "text_lm.sqlite3", fresh=False)
    try:
        c = new_client()
        before = [torch.cuda.memory_allocated(i) for i in range(2)]
        with _fleet_sizing(1, 1), _Env(RAFIKI_PREDICTOR_PORTS="1"):
            t0 = time.perf_counter()
            inf = c.create_inference_job("lm",
                                         budget={"CHIPS_PER_WORKER": 2})
            deploy_s = time.perf_counter() - t0
            after = [torch.cuda.memory_allocated(i) for i in range(2)]
            got = generate_pass(c, "lm", LM_RUN["prompts"])
        c.stop_inference_job("lm")
    finally:
        server.stop()
        admin.shutdown()
    (w,) = inf["workers"]
    require(w["chips"] == [0, 1], f"the LM's grant {w['chips']}")
    require(after[0] - before[0] > 1 << 28 and after[1] == before[1],
            f"device memory {before} -> {after}: the LM is not on the "
            "grant's first card alone")
    for a, b, h in zip(got["tokens"], LM_RUN["greedy"]["tokens"],
                       LM_RUN["held"]):
        same_until(a, b, h, "CHIPS_PER_WORKER=2 and one-card greedy streams")
    same = sum(a == b for a, b in zip(got["tokens"],
                                      LM_RUN["greedy"]["tokens"]))
    print(f"fleet: 16d 8b's LM under CHIPS_PER_WORKER=2 on grant "
          f"{w['chips']} (deploy {deploy_s:.1f} s): "
          f"{(after[0] - before[0]) / 2**20:.0f} MiB on cuda:0, "
          f"{(after[1] - before[1]) / 2**20:.0f} MiB on cuda:1; "
          f"{STREAMS} greedy streams of {GEN_TOKENS} tokens equal the "
          f"one-card streams up to their held positions {LM_RUN['held']} "
          f"({same} of {STREAMS} whole); card {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 17: the drift closed loop and the sandbox
# ---------------------------------------------------------------------------

#: 17a's drift loop: 1-s windows of 8 samples, ticks driven here (the
#: loop thread idles on an hour), a retrain of one trial, one launch
#: retry before the loop parks, a 1-s cooldown; the rollout's judge
#: over 2 s with 3 canary requests, the canary taking half the requests
DRIFT_ENV = {"RAFIKI_DRIFT": "1", "RAFIKI_DRIFT_INTERVAL_S": "3600",
             "RAFIKI_DRIFT_WINDOW_S": "1",
             "RAFIKI_DRIFT_BASELINE_WINDOW_S": "1",
             "RAFIKI_DRIFT_MIN_SAMPLES": "8", "RAFIKI_DRIFT_THRESHOLD": "0.5",
             "RAFIKI_DRIFT_RETRAIN_BUDGET": "1",
             "RAFIKI_DRIFT_COOLDOWN_S": "1",
             "RAFIKI_DRIFT_LAUNCH_RETRY_MAX": "1",
             "RAFIKI_ROLLOUT_JUDGE_WINDOW_S": "2",
             "RAFIKI_ROLLOUT_MIN_REQUESTS": "3",
             "RAFIKI_ROLLOUT_CANARY_FRACTION": "0.5"}
#: the baseline's traffic cycles over this many of phase 3's test images;
#: the shifted traffic is its training images, which the baseline never saw
DRIFT_BASE_IMAGES = 4
#: 17b's RAFIKI_TRIAL_STALL_S: a mute child is killed this long after its
#: spawn
STALL_DRILL_S = "3"
#: 17a's narrow leg (run when the full-width candidate scored no better):
#: TorchViT at 2 blocks of width 64 (2 heads, Dh 32) on the same images,
#: its score set through the environment as tests/fixtures/drift_model.py
#: sets its own, after its real evaluate
NARROW_DRIFT_EDITS = [
    ("class TorchViT(BaseModel):", "class NarrowDriftViT(BaseModel):"),
    ('"dim": FixedKnob(768)', '"dim": FixedKnob(64)'),
    ('"depth": FixedKnob(12)', '"depth": FixedKnob(2)'),
    ('"heads": FixedKnob(12)', '"heads": FixedKnob(2)'),
    ('"num_classes": FixedKnob(1000)', '"num_classes": FixedKnob(10)'),
    ("        return classification_accuracy(self._trainer, self._model, x, y)",
     "        classification_accuracy(self._trainer, self._model, x, y)\n"
     "        import os\n"
     "        return float(os.environ.get(\"DRIFT_SMOKE_SCORE\", \"0.5\"))"),
]
#: the mute template of 17b's STALL drill
MUTE_TEMPLATE = b'''
import time

from rafiki_tpu_torch.sdk.knob import FixedKnob
from rafiki_tpu_torch.sdk.model import BaseModel


class Mute(BaseModel):
    @staticmethod
    def get_knob_config():
        return {"k": FixedKnob(1)}

    def train(self, dataset_uri):
        time.sleep(600)  # never speaks

    def evaluate(self, dataset_uri):
        return 0.0

    def predict(self, queries):
        return queries

    def dump_parameters(self):
        return {}

    def load_parameters(self, params):
        pass
'''


class _DriftLoad:
    """A client thread calling ``Admin.predict`` with one image at a time:
    the baseline's few test images in turn, or, once ``novel`` is set,
    phase 3's training images in order. Each failure is kept."""

    def __init__(self, admin, uid: str, app: str, base, novel):
        self.ok, self.failed = 0, []
        self.novel = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(admin, uid, app, base, novel),
            daemon=True)
        self._thread.start()

    def _run(self, admin, uid, app, base, novel):
        i = j = 0
        while not self._stop.is_set():
            if self.novel.is_set():
                image, j = novel[j % len(novel)], j + 1
            else:
                image, i = base[i % len(base)], i + 1
            try:
                got = np.asarray(admin.predict(uid, app, [image]))
                if (got.ndim == 2 and got.shape[0] == 1
                        and np.isfinite(got).all()):
                    self.ok += 1
                    continue
                self.failed.append(f"answer of shape {got.shape}")
            except Exception as e:
                self.failed.append(repr(e))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(120)
        require(not self._thread.is_alive(), "the drift load thread hung")


def _drift_ticks(admin, job_id: str, pred, actions: list,
                 timeout_s: float = 120) -> dict:
    """Tick the drift loop until its row satisfies ``pred``; every tick's
    actions go to ``actions``."""
    deadline = time.monotonic() + timeout_s
    st = None
    while time.monotonic() < deadline:
        actions += [a["action"] for a in admin.drift.tick()]
        st = admin.drift.status(job_id)
        if st is not None and pred(st):
            return st
        time.sleep(0.05)
    raise SmokeFailure(f"the drift loop never got there: {st}; actions "
                       f"{actions}")


def _drift_cycle(admin, uid: str, app: str, load, actions: list,
                 sandboxed: bool, score_env: str = None) -> tuple:
    """A baseline on the load's base images, then the shift to novel ones:
    the verdict and one warm-started retrain (trained in a sandbox child
    with ``sandboxed``), and the loop's answer: the rollout to DONE or the
    cooldown. Returns (the retrain's row, the candidate's and the
    incumbent's best rows, the branch, seconds from the verdict to the
    retrain's STOPPED)."""
    from rafiki_tpu_torch.constants import DriftPhase

    tj = admin.db.get_train_job_by_app_version(uid, app, -1)
    job_id = admin.db.get_running_inference_job_of_train_job(tj["id"])["id"]
    (incumbent,) = admin.db.get_best_trials_of_train_job(tj["id"],
                                                         max_count=1)
    if load.novel.is_set():
        # the baseline's window must hold the base images alone
        load.novel.clear()
        time.sleep(float(DRIFT_ENV["RAFIKI_DRIFT_WINDOW_S"]) + 0.5)
    _drift_ticks(admin, job_id, lambda st: st["phase"] == DriftPhase.WATCHING
                 and st.get("baseline") is not None, actions)
    load.novel.set()
    time.sleep(float(DRIFT_ENV["RAFIKI_DRIFT_WINDOW_S"]) + 0.5)
    env = {"RAFIKI_SANDBOX": "1"} if sandboxed else {}
    if score_env is not None:
        env["DRIFT_SMOKE_SCORE"] = score_env
    with _Env(**env):
        t0 = time.perf_counter()
        st = _drift_ticks(admin, job_id, lambda st: st.get("retrain_job_id")
                          is not None, actions)
        retrain = admin.wait_until_train_job_stopped(uid, app, timeout_s=900)
        retrain_s = time.perf_counter() - t0
    require(retrain["id"] == st["retrain_job_id"]
            and retrain["status"] == "STOPPED"
            and retrain["budget"]["MODEL_TRIAL_COUNT"] == 1,
            f"the retrain {retrain}")
    trials = admin.db.get_trials_of_train_job(retrain["id"])
    require([t["status"] for t in trials] == ["COMPLETED"],
            "the retrain's trial: " + "; ".join(
                f"{t['status']} {t['fault_kind']} {t['fault_detail']}"
                for t in trials))
    (cand,) = admin.db.get_best_trials_of_train_job(retrain["id"],
                                                    max_count=1)
    st = _drift_ticks(admin, job_id, lambda st: st["phase"] in (
        DriftPhase.WATCHING, DriftPhase.COOLDOWN) and not
        admin.rollouts.is_active(job_id), actions, timeout_s=300)
    branch = ("rollout_done" if actions[-1] == "rollout_done"
              else actions[-1])
    return retrain, cand, incumbent, branch, retrain_s, job_id


def _narrow_drift_leg(card: str, admin, c, uid: str, uris: dict,
                      images: dict) -> list:
    """17a's rollout branch on the card, when the full-width candidate
    scored no better: a narrow ViT whose score the environment sets, its
    candidate better, rolled out to DONE under the load. Returns the tick
    actions."""
    source = TEMPLATE.read_text()
    for old, new in NARROW_DRIFT_EDITS:
        require(source.count(old) == 1, f"narrow edit {old!r}")
        source = source.replace(old, new)
    c.create_model("vit-narrow-drift", "IMAGE_CLASSIFICATION",
                   source.encode(), "NarrowDriftViT")
    with _Env(DRIFT_SMOKE_SCORE="0.5"):
        c.create_train_job("vitn", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": 1,
                                                 "CHIP_COUNT": 0},
                           models=["vit-narrow-drift"])
        job = c.wait_until_train_job_stopped("vitn", timeout_s=900,
                                             poll_s=0.05)
    require(job["status"] == "STOPPED", f"vitn job {job['status']}")
    inf = c.create_inference_job("vitn")
    load = _DriftLoad(admin, uid, "vitn", images["base"], images["novel"])
    actions = []
    try:
        retrain, cand, inc, branch, retrain_s, job_id = _drift_cycle(
            admin, uid, "vitn", load, actions, sandboxed=False,
            score_env="0.9")
    finally:
        load.stop()
    ro = admin.rollouts.status(job_id)
    live = {w["trial_id"]
            for w in admin.services.live_inference_workers(job_id)}
    require(branch == "rollout_done" and ro["phase"] == "DONE"
            and live == {cand["id"]}, f"the narrow leg's branch {branch}, "
            f"rollout {ro and ro['phase']}, serving {live}")
    require(not load.failed and load.ok > 0,
            f"the narrow leg's load: {load.ok} answered, failed "
            f"{load.failed[:3]}")
    print(f"drift: 17a narrow leg (ViT 2 x 64, 224/16, the score set as "
          f"the drift fixture's): incumbent {inc['score']:.4f}, candidate "
          f"{cand['score']:.4f}; the retrain STOPPED {retrain_s:.1f} s "
          f"after the shift's verdict tick; the rollout to DONE "
          f"({inf['workers'][0]['chips']}), {load.ok} requests answered "
          f"under it, none failed; actions {actions}; card {card}",
          flush=True)
    c.stop_inference_job("vitn", job["app_version"])
    return actions


def drift_sandbox_phase(card: str, uris: dict) -> list:
    """Phase 17 on phase 5's store (its ViT-B/16 template): 17a a
    one-trial incumbent, then the drift loop through the admin under a
    steady client, its retrain (one
    warm-started ViT-B/16 trial) trained in a sandbox child on the card,
    the branch the scores decide, the ``drift`` chaos site's launch
    failures parking the loop and ``Client.ack_drift`` re-arming it; 17b
    the retrain's version deployed through the client under the sandbox,
    its replica's ``SandboxedModelServer`` child answering as the same
    parameters' in-process forward, a STALL drill and the fused
    ensemble's refusal under the sandbox. Returns each kernel's launches
    on this path: this process's counters and the children's reports."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.services import ServiceDeploymentError
    from rafiki_tpu_torch.constants import DriftPhase
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.sdk import sandbox
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.utils import chaos

    t_phase = time.perf_counter()
    kernels = _kernels()
    with np.load(uris["test"]) as z:
        base = list(z["x"][:DRIFT_BASE_IMAGES])
        held = z["x"][DRIFT_BASE_IMAGES:DRIFT_BASE_IMAGES + 8]
    with np.load(uris["train"]) as z:
        novel = list(z["x"])
    images = {"base": base, "novel": novel}
    # the sandbox's jails go under WORK (RAFIKI_WORKDIR), not the checkout
    with _Env(**DRIFT_ENV, RAFIKI_WORKDIR=str(WORK)), _fleet_sizing(1, 1):
        admin, server, new_client = _stack("stack", "stack.sqlite3",
                                           fresh=False)
        try:
            c = new_client()
            uid = admin.authenticate_user(
                config.SUPERADMIN_EMAIL,
                config.SUPERADMIN_PASSWORD)["user_id"]
            # ---- the main path's run (17a-b): counts from zero ----
            for kernel in kernels:
                kernel.launches = 0
            require(admin.drift.running, "RAFIKI_DRIFT=1 started no loop")
            # the incumbent: one ViT-B/16 trial asking no card of its own
            # (CHIP_COUNT 0), so its retrain shares the card the serving
            # replica holds, as phase 5's one-card grant could not
            c.create_train_job("drift", "IMAGE_CLASSIFICATION",
                               uris["train"], uris["test"],
                               budget={"MODEL_TRIAL_COUNT": 1,
                                       "CHIP_COUNT": 0},
                               models=["vit-b16"])
            job = c.wait_until_train_job_stopped("drift", timeout_s=900,
                                                 poll_s=0.05)
            require(job["status"] == "STOPPED", f"the incumbent's job {job}")
            inf = c.create_inference_job("drift")
            job_id = inf["id"]
            load = _DriftLoad(admin, uid, "drift", base, novel)
            actions = []
            try:
                retrain, cand, inc, branch, retrain_s, _ = _drift_cycle(
                    admin, uid, "drift", load, actions, sandboxed=True)
                t_cycle = time.perf_counter()
                st = admin.drift.status(job_id)
                names = [e["event"] for e in st["events"]]
                require(actions[:2] == ["baseline", "drift"]
                        and "novelty" in next(
                            e["detail"] for e in st["events"]
                            if e["event"] == "drift"),
                        f"the verdict: actions {actions}, events {names}")
                require(len(admin.db.get_train_jobs_of_app(uid, "drift"))
                        == 2, "not exactly one retrain")
                ro = admin.rollouts.status(job_id)
                live = {w["trial_id"]
                        for w in admin.services.live_inference_workers(
                            job_id)}
                if branch == "rollout_done":
                    require(ro["phase"] == "DONE" and live == {cand["id"]}
                            and float(cand["score"]) > float(inc["score"]),
                            f"rollout {ro}, serving {live}")
                else:
                    require(branch == "candidate_worse" and ro is None
                            and live == {inc["id"]}
                            and float(cand["score"]) <= float(inc["score"])
                            and "keeping the incumbent" in st["reason"],
                            f"branch {branch}, rollout {ro}, serving {live}"
                            f", reason {st['reason']}")
                # the child's report, as the worker wrote it to the
                # trial's log
                trial_report = sandbox.report_in_log(
                    c.get_trial_logs(cand["id"])["messages"])
                require(trial_report is not None,
                        "the retrain's trial log holds no child report")
                steps = TRAIN_IMAGES // cand["knobs"]["batch_size"]
                child = [trial_report["launches"][name] for name in COUNTERS]
                expect = [DEPTH, DEPTH * steps, DEPTH * steps,
                          DEPTH * steps]
                require(child == expect, f"the retrain child launched "
                        f"{child}, expected {expect}")
                require(trial_report["devices"] == ["cuda:0"]
                        and len(trial_report["libraries"]) == 2,
                        f"the retrain child's report {trial_report}")
                print(f"drift: 17a ViT-B/16 (224/16, 768 x 12) served from "
                      f"its best trial under a steady client; the baseline "
                      f"froze on {DRIFT_BASE_IMAGES} test images; the shift "
                      f"to phase 3's training images: verdict "
                      f"{next(e['detail'] for e in st['events'] if e['event'] == 'drift')!r};"
                      f" exactly one warm-started retrain (budget 1), "
                      f"trained in a sandbox child and STOPPED "
                      f"{retrain_s:.1f} s after the verdict tick; scores: "
                      f"candidate {cand['score']:.4f} vs incumbent "
                      f"{inc['score']:.4f}: branch {branch}; actions "
                      f"{actions}; events {names}; card {card}",
                      flush=True)
                wall = retrain["datetime_stopped"] - retrain["datetime_started"]
                print(f"drift: the retrain's trial in its child: "
                      f"{trial_split(c.get_trial_logs(cand['id'])['metrics'], wall)}"
                      f" (the job {wall:.1f} s)", flush=True)
                print(f"drift: the retrain child: pid {trial_report['pid']}"
                      f", euid {trial_report['euid']}, egid "
                      f"{trial_report['egid']}, uid drop "
                      f"{'ran' if trial_report['uid_dropped'] else 'did not run (the smoke is not root)'}"
                      f", devices {trial_report['devices']} "
                      f"({trial_report['device_names']}), libraries "
                      f"{[Path(p).name for p in trial_report['libraries']]}"
                      f"; launches K1 {child[0]}, K1-LSE {child[1]}, K2 "
                      f"{child[2]}, K3 {child[3]} ({steps} steps, expected "
                      f"{expect})", flush=True)
                # ---- the drift chaos site: the launch fails, then parks
                park_actions = []
                chaos.install([chaos.ChaosRule(
                    site=chaos.SITE_DRIFT, action=chaos.ACTION_ERROR,
                    match=f"launch/{job_id}")])
                try:
                    load.novel.clear()
                    time.sleep(float(DRIFT_ENV["RAFIKI_DRIFT_WINDOW_S"])
                               + 0.5)
                    _drift_ticks(admin, job_id, lambda st: st["phase"] ==
                                 DriftPhase.WATCHING and st.get("baseline")
                                 is not None, park_actions)
                    load.novel.set()
                    time.sleep(float(DRIFT_ENV["RAFIKI_DRIFT_WINDOW_S"])
                               + 0.5)
                    st = _drift_ticks(admin, job_id, lambda st: st["phase"]
                                      == DriftPhase.PARKED, park_actions)
                finally:
                    chaos.clear()
                require(len(admin.db.get_train_jobs_of_app(uid, "drift"))
                        == 2 and "bounded" in st["reason"],
                        f"the parked loop launched a retrain: {st}")
                acked = c.ack_drift("drift")
                require(acked["phase"] == DriftPhase.WATCHING
                        and acked["operator_ack"] is True,
                        f"ack_drift answered {acked}")
                t_park = time.perf_counter()
            finally:
                load.stop()
            require(not load.failed and load.ok > 0,
                    f"the load: {load.ok} answered, failed "
                    f"{load.failed[:3]}")
            print(f"drift: 17a chaos at the drift site's launch: "
                  f"{[e['event'] for e in acked['events']][-4:]}; "
                  f"PARKED ({st['reason'][:60]}...), no retrain launched, "
                  f"then Client.ack_drift re-armed the loop (WATCHING, "
                  f"operator_ack); {load.ok} requests answered over 17a, "
                  f"none failed ({t_park - t_cycle:.1f} s)", flush=True)
            # version 1: the retrain's own version serves nothing
            c.stop_inference_job("drift", job["app_version"])
            narrow = (_narrow_drift_leg(card, admin, c, uid, uris, images)
                      if branch != "rollout_done" else None)
            t_a = time.perf_counter()

            # ---- 17b: the candidate served from a sandbox child ----
            row = admin.db.get_trial(cand["id"])
            model = load_model_class(TEMPLATE.read_bytes(), "TorchViT")(
                **row["knobs"])
            model.load_parameters(load_params(read_artifact(
                row["params_file_path"])))
            ref = np.asarray(model.predict(held))
            model.destroy()
            # the retrain's version deployed through the client under the
            # sandbox: its worker serves from a SandboxedModelServer child
            # on its grant's first card, recorded as it is made so that
            # the child's report can be read while it serves
            servers = []

            class _Recorded(sandbox.SandboxedModelServer):
                def __init__(self, *args, **kw):
                    super().__init__(*args, **kw)
                    servers.append(self)

            real_server = sandbox.SandboxedModelServer
            sandbox.SandboxedModelServer = _Recorded
            try:
                with _Env(RAFIKI_SANDBOX="1"):
                    t0 = time.perf_counter()
                    served_inf = c.create_inference_job(
                        "drift", app_version=retrain["app_version"])
                    ready_s = time.perf_counter() - t0
                    got = np.asarray(c.predict(
                        "drift", held.tolist(),
                        app_version=retrain["app_version"]))
                    require(len(servers) == 1, f"{len(servers)} sandboxed "
                            "servers for one replica")
                    report = servers[0].report()
                    c.stop_inference_job("drift", retrain["app_version"])
            finally:
                sandbox.SandboxedModelServer = real_server
            (worker_row,) = served_inf["workers"]
            require(worker_row["trial_id"] == cand["id"],
                    f"the sandboxed replica serves {worker_row}")
            held_line = prob_check("the sandboxed replica", got, ref)
            served = report["launches"]["flash_attention"]
            # serving loads the forward's library alone
            require(served > 0 and served % DEPTH == 0 and not any(
                report["launches"][n] for n in COUNTERS[1:])
                and report["devices"] == ["cuda:0"]
                and report["libraries"] == [
                    str(_build.library_path("flash_fwd"))],
                f"the serving child's report {report}")
            serve_child = [served, 0, 0, 0]
            print(f"sandbox: 17b the retrain's version deployed through "
                  f"Client.create_inference_job under RAFIKI_SANDBOX=1 "
                  f"(deploy {ready_s:.1f} s, the child's warm-up "
                  f"included), its replica ({worker_row['chips']}) "
                  f"serving the candidate from a SandboxedModelServer "
                  f"child (pid {report['pid']}, euid {report['euid']}, "
                  f"uid drop "
                  f"{'ran' if report['uid_dropped'] else 'did not run'}, "
                  f"devices {report['devices']}, libraries "
                  f"{[Path(p).name for p in report['libraries']]}): 8 "
                  f"images through Client.predict against the same "
                  f"parameters' in-process forward: {held_line}; K1 "
                  f"launched {served} times in the child (warm-up and the "
                  f"batch); card {card}", flush=True)
            # ---- a STALL drill ----
            t0 = time.perf_counter()
            with _Env(RAFIKI_TRIAL_STALL_S=STALL_DRILL_S):
                try:
                    sandbox.run_trial_sandboxed(
                        MUTE_TEMPLATE, "Mute", {"k": 1}, uris["train"],
                        uris["test"], sandbox.make_jail(str(WORK), "mute"),
                        on_log_line=lambda line: None, devices=[0])
                    stalled = None
                except sandbox.SandboxError as e:
                    stalled = e
            stall_s = time.perf_counter() - t0
            require(isinstance(stalled, sandbox.SandboxStallError)
                    and stalled.kind == "STALL"
                    and stall_s < float(STALL_DRILL_S) + 30,
                    f"the mute child: {stalled!r} after {stall_s:.1f} s")
            # ---- fused serving under the sandbox is refused, typed ----
            with _Env(RAFIKI_SANDBOX="1"):
                try:
                    admin.create_inference_job(
                        uid, "drift", app_version=retrain["app_version"],
                        budget={"ENSEMBLE_FUSED": 1})
                    refused = None
                except ServiceDeploymentError as e:
                    refused = e
            (fused_job,) = [
                j for j in admin.db.get_inference_jobs_of_train_job(
                    retrain["id"]) if j["id"] != served_inf["id"]]
            require(refused is not None and "RAFIKI_SANDBOX=1"
                    in str(refused) and fused_job["status"] == "ERRORED",
                    f"the fused deploy under the sandbox: {refused!r}, "
                    f"job {fused_job['status']}")
            print(f"sandbox: 17b a mute child (RAFIKI_TRIAL_STALL_S="
                  f"{STALL_DRILL_S}) raised {type(stalled).__name__} (kind "
                  f"{stalled.kind}) in {stall_s:.1f} s; ENSEMBLE_FUSED "
                  f"under RAFIKI_SANDBOX=1 refused with "
                  f"{type(refused).__name__} and the job ERRORED "
                  f"({time.perf_counter() - t_a:.1f} s)", flush=True)
        finally:
            server.stop()
            admin.shutdown()
    torch.cuda.synchronize()
    here = [k.launches for k in kernels]
    counts = [a + b + s for a, b, s in zip(here, child, serve_child)]
    require(all(counts), f"a kernel not launched on phase 17's path: "
            f"{counts}")
    print(f"drift and sandbox: launches this process {here}, the retrain "
          f"child {child}, the serving child {serve_child}; 17a took "
          f"{t_a - t_phase:.0f} s{'' if narrow is None else ' (the narrow leg included)'}"
          f", 17b {time.perf_counter() - t_a:.0f} s; phase 17 took "
          f"{time.perf_counter() - t_phase:.0f} s; card {card}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 18: control-plane HA and crash recovery
# ---------------------------------------------------------------------------

HA_TTL_S = 3.0      # the leadership lease's TTL (a renewal every 1 s)
HA_EPOCHS = 1       # 18a's trials: 1 epoch of 512 images at batch 64
HA_BATCH = 64
HA_IMAGES = 8       # 18b's requests: 8 images as JSON, in requests that fit
HA_WAIT_S = 600     # any wait of the phase (a job, a boot, a deploy)
#: 18a's model: HaViT whose train, once its epoch is reported, waits for
#: the drill's gate file (at most HA_WAIT_S), so the first trial's
#: evaluation and the whole second trial fall after the promotion however
#: fast the card trains
_HA_GATED = f"""

import os as _os
import time as _time


class GatedHaViT(HaViT):
    def train(self, dataset_uri):
        super().train(dataset_uri)
        deadline = _time.monotonic() + {HA_WAIT_S}
        while (not _os.path.exists(_os.environ["CHIP_SMOKE_HA_GATE"])
               and _time.monotonic() < deadline):
            _time.sleep(0.05)
"""

_HA_STANDBY = """
import logging, signal, sys, threading
logging.basicConfig(level=logging.INFO,
                    format="%(levelname)s:%(asctime)s:%(name)s: %(message)s")
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.admin.standby import StandbyAdmin
from rafiki_tpu_torch.db.database import Database

port = int(sys.argv[1])
server = None


def promote(lease):
    # the promoted admin's children reach the advisor through this door
    admin = Admin(db=Database(config.DB_PATH), lease=lease)
    admin.placement.admin_addr = ("127.0.0.1", server.port)
    return admin


standby = StandbyAdmin(Database(config.DB_PATH), factory=promote,
                       addr=f"127.0.0.1:{port}")
server = AdminServer(standby, port=port).start()
print(f"standby on http://127.0.0.1:{server.port}", flush=True)
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *a: stop.set())
stop.wait()
server.stop()
standby.shutdown()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ha_start(env: dict, log: Path, argv: list,
              session: bool = False) -> tuple:
    """Start a process of the phase (``session``: in a session and process
    group of its own), its errors to ``log``, and a thread reading its
    first line of output; pass the handle to ``_ha_line``."""
    t0 = time.perf_counter()
    with open(log, "a") as err:
        proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=err, text=True,
                                start_new_session=session)
    lines = []

    def read():
        lines.append(proc.stdout.readline())
        lines.append(time.perf_counter())

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, reader, lines, t0, log, argv


def _ha_line(handle: tuple) -> tuple:
    """(process, its first line of output, seconds from its start to
    it)."""
    proc, reader, lines, t0, log, argv = handle
    reader.join(timeout=180)
    line = lines[0].strip() if lines else ""
    require(bool(line), f"no first line from {argv[-1]!r} in "
            f"{time.perf_counter() - t0:.0f} s: {log.read_text()[-3000:]}")
    return proc, line, lines[1] - t0


def _ha_proc(env: dict, log: Path, argv: list) -> tuple:
    return _ha_line(_ha_start(env, log, argv))


def _root(port: int) -> dict:
    """The public root of the door on ``port`` (None when it does not
    answer within 5 s)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=5) as resp:
            return json.loads(resp.read())["data"]
    except (OSError, ValueError):
        return None


def _door_call(port: int, method: str, path: str, body: dict,
               token: str) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {token}"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stop_proc(proc, sig=signal.SIGTERM, timeout: float = 120) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def _wait_until(cond, timeout_s: float, what: str, poll_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        require(time.monotonic() < deadline, what)
        time.sleep(poll_s)


def _running(pid: int) -> bool:
    """Is ``pid`` a live process (not gone, not a zombie no one reaped:
    a child of a killed admin is reparented)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _card_mib() -> str:
    """The card's used memory and each process's, from nvidia-smi."""
    free, total = torch.cuda.mem_get_info(0)
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=used_memory",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return (f"{(total - free) / 2**20:.0f} MiB used of {total / 2**20:.0f}"
            f" (the processes on it: " + "; ".join(
                ln.strip() for ln in apps.splitlines() if ln.strip())
            + ")")


def _shm_files(prefix: str) -> dict:
    """Size of each ``/dev/shm`` entry whose name starts ``prefix``."""
    return {p.name: p.stat().st_size for p in Path("/dev/shm").glob(
        prefix + "*")}


def _one_record(logs: Path, sid: str, kind: str) -> list:
    return [json.loads(m.group(2)) | {"pid": int(m.group(1))}
            for m in re.finditer(kind + r" \(pid (\d+)\): (\{.*\})",
                                 (logs / f"service-{sid}.log").read_text())]


def ha_failover(card: str, uris: dict, env: dict, logs: Path,
                store: str) -> tuple:
    """18a: a leader and a hot standby, each a process, over one store,
    under ``RAFIKI_ADMIN_HA=1``; a ViT-B/16 train job of 2 trials of
    ``HA_EPOCHS`` epochs in one process-placed train child; the leader
    SIGSTOPped past its TTL after the first trial's epoch report (the
    trial then waits on a gate file, opened once the promotion's launch
    counts are logged), the standby promoted, the leader SIGCONTed
    (fenced) and SIGKILLed; the promoted leader adopts the child by pid. Returns (each kernel's launches in
    the train child, the train job's id, the seconds it took)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database

    p1, p2 = _free_port(), _free_port()
    addrs = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    cards = torch.cuda.device_count()
    gate = logs / "gate"
    ha_env = {**env, "CHIP_SMOKE_HA_GATE": str(gate),
              "RAFIKI_ADMIN_HA": "1",
              "RAFIKI_ADMIN_LEASE_TTL_S": str(HA_TTL_S),
              "RAFIKI_ADMIN_ADDRS": ",".join(addrs)}
    t_phase = time.perf_counter()
    leader, banner, boot_s = _ha_proc(
        {**ha_env, "RAFIKI_ADMIN_PORT": str(p1)}, logs / "leader.log",
        [sys.executable, "-m", "rafiki_tpu_torch.admin"])
    require(f"admin on http://127.0.0.1:{p1}" in banner, banner)
    standby = child_pid = None
    try:
        # the standby boots (after the leader took the lease) while the
        # job starts
        booting = _ha_start({**ha_env, "RAFIKI_ADMIN_PORT": str(p2)},
                            logs / "standby.log",
                            [sys.executable, "-c", _HA_STANDBY, str(p2)])
        standby = booting[0]
        c = Client(admin_addrs=addrs, timeout_s=HA_WAIT_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        token = c._token
        c.create_model("vit-b16", "IMAGE_CLASSIFICATION", twin_template(
            "HaViT", "FloatKnob(1e-5, 1e-3, is_exp=True)", HA_BATCH,
            HA_EPOCHS, checkpoint=False) + _HA_GATED.encode(),
            "GatedHaViT")
        budget = {"MODEL_TRIAL_COUNT": TRIALS, "CHIP_COUNT": 1}
        if cards >= 2:
            budget.update(CHIP_COUNT=2, CHIPS_PER_TRIAL=2)
        t0 = time.perf_counter()
        c.create_train_job("ha", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget=budget)
        db = Database(store)  # reads only: this process writes nothing
        job = db.get_train_jobs_of_app(
            db.get_user_by_email(config.SUPERADMIN_EMAIL)["id"], "ha")[0]
        (worker,) = db.get_workers_of_train_job(job["id"])
        sid = worker["service_id"]
        first = _wait_until(
            lambda: [t for t in db.get_trials_of_train_job(job["id"])
                     if any('"epoch":' in line
                            for line in db.get_trial_logs(t["id"]))],
            HA_WAIT_S, "no epoch report of the first trial")[0]
        standby, line, standby_s = _ha_line(booting)
        root = _root(p2)
        require(root and root["ha"]["role"] == "standby"
                and root["ha"]["leader"] == addrs[0],
                f"the standby's root {root}")
        print(f"ha: leader {banner!r} in {boot_s:.1f} s (lease TTL "
              f"{HA_TTL_S:g} s); standby {line!r} in {standby_s:.1f} s "
              f"(booted beside the job's start), role {root['ha']['role']},"
              f" leader hint {root['ha']['leader']}; card {card}",
              flush=True)
        svc = db.get_service(sid)
        child_pid = svc["pid"]
        fds = {n: os.readlink(f"/proc/{child_pid}/fd/{n}")
               for n in (0, 1, 2)}
        require(fds[1] == fds[2] == str(logs / f"service-{sid}.log")
                and fds[0] == "/dev/null",
                f"the train child's stdio {fds}")
        mem_before = _card_mib()

        # ---- the leader stops past its TTL; the standby promotes ----
        t_stop = time.perf_counter()
        leader.send_signal(signal.SIGSTOP)
        _wait_until(lambda: (_root(p2) or {}).get("ha", {}).get("role")
                    == "leader", HA_WAIT_S, "the standby never promoted",
                    poll_s=0.02)
        t_promoted = time.perf_counter()
        os.kill(child_pid, signal.SIGUSR1)  # its launches so far
        _wait_until(lambda: _one_record(logs, sid, "kernel launches so far"),
                    60, "no launch counts from the train child")
        gate.touch()  # the first trial goes on to its evaluation
        _wait_until(lambda: (_root(p2) or {}).get("recovery", {}).get(
            "state") == "ready", HA_WAIT_S, "the promoted leader never "
            "reached ready", poll_s=0.02)
        t_ready = time.perf_counter()
        require(db.read_lease()["epoch"] == 2, f"lease {db.read_lease()}")
        # ---- the old leader comes back: fenced, its write refused ----
        leader.send_signal(signal.SIGCONT)
        status, body = _door_call(p1, "POST", "/users", {
            "email": "stale@ha", "password": "p", "user_type": "ADMIN"},
            token)
        require(status == 503 and body.get("standby") is True
                and body.get("leader") == addrs[1]
                and "StaleEpochError" in body.get("error", ""),
                f"the old leader answered {status} {body}")
        require(db.get_user_by_email("stale@ha") is None,
                "the fenced leader's write landed")
        # a route that writes nothing to the store is shed too: its stale
        # advisor session answers no one
        (sub,) = db.get_sub_train_jobs_of_train_job(job["id"])
        adv_status, adv_body = _door_call(
            p1, "POST", f"/advisors/{sub['id']}/propose", {}, token)
        require(adv_status == 503 and adv_body.get("standby") is True
                and adv_body.get("leader") == addrs[1],
                f"the old leader's advisor route answered {adv_status} "
                f"{adv_body}")
        role = _wait_until(lambda: ((_root(p1) or {}).get("ha") or {}).get(
            "role") == "fenced", 5 * HA_TTL_S, "the old leader's role")
        leader.send_signal(signal.SIGKILL)
        leader.wait(timeout=60)
        mem_adopted = _card_mib()
        print(f"ha: SIGSTOP of the leader to the promotion "
              f"{t_promoted - t_stop:.2f} s, promotion to ready "
              f"{t_ready - t_promoted:.2f} s; the SIGCONTed leader answered "
              f"{status} ({body['error'][:40]}...; leader hint "
              f"{body['leader']}), role fenced={role}, and its write did "
              f"not land; its advisor route answered {adv_status} too; "
              f"SIGKILLed", flush=True)

        # ---- from here no client call may fail ----
        failed = []
        c.wait_until_admin_ready(timeout_s=HA_WAIT_S)

        def polled():
            try:
                return c.get_train_job("ha")["status"] == "STOPPED"
            except Exception as e:
                failed.append(repr(e))
                return False

        _wait_until(polled, HA_WAIT_S, "the train job never STOPPED",
                    poll_s=0.5)
        job_s = time.perf_counter() - t0
        trials = c.get_trials_of_train_job("ha")
        _wait_until(lambda: not _running(child_pid), 120,
                    "the adopted child never exited")
        mem_after = _card_mib()
    finally:
        if leader.poll() is None:
            leader.send_signal(signal.SIGCONT)
            _stop_proc(leader, signal.SIGKILL)
        if standby is not None:
            _stop_proc(standby)
        if child_pid is not None and _running(child_pid):
            os.kill(child_pid, signal.SIGKILL)
    report = json.loads((logs / "recovery-e2.json").read_text())
    require(report["adopted"] == 1 and report["errored"] == 0
            and not report.get("failed"), f"the promoted leader's report "
            f"{report}")
    require(not failed, f"client calls failed after ready: {failed}")
    require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS
            and all(np.isfinite(t["score"]) for t in trials),
            f"trials {trials}")
    standby_log = (logs / "standby.log").read_text()
    adopted = re.search(r"adopted surviving worker \S+ \(pid (\d+), grant "
                        r"(\[.*?\])\)", standby_log)
    require(adopted and int(adopted.group(1)) == child_pid,
            f"no adoption line for pid {child_pid} in the standby's log")
    log = (logs / f"service-{sid}.log").read_text()
    require("surviving for the next admin" in log,
            "the child never noticed its parent's death")
    # the child's client logs each call answered by another address than
    # the last: every one after the leader's stop is the promoted one's
    walks = re.findall(r"admin call (\S+ \S+) answered by (\S+), walked "
                       r"on from (\S+)", log)
    require(walks and all(w[1:] == (addrs[1], addrs[0]) for w in walks)
            and walks[0][0].startswith("POST /advisors/"),
            f"the child's calls walked {walks}")
    (so_far,) = _one_record(logs, sid, "kernel launches so far")
    # the child's own line (a follower on a card of its own writes one too)
    (total,) = [r for r in _one_record(logs, sid, "kernel launches")
                if r["pid"] == child_pid]
    steps = (TRAIN_IMAGES // HA_BATCH) * HA_EPOCHS * TRIALS
    got = [total[k] for k in COUNTERS]
    expect = [DEPTH * TRIALS] + [DEPTH * steps] * 3
    require(got == expect, f"the train child launched {got}, expected "
            f"{expect}")
    before = [so_far[k] for k in COUNTERS]
    after = [g - b for g, b in zip(got, before)]
    # the gate holds the first trial, trained, until after the promotion
    require(before == [0] + [DEPTH * steps // TRIALS] * 3,
            f"the train child had launched {before} at the promotion, "
            f"not the first trial's training alone")
    require(all(a > 0 for a in after), f"the adopted child launched "
            f"no kernel after the promotion: {before} then {got}")
    print(f"ha: the train child (pid {child_pid}, stdio {fds[1]}) adopted by"
          f" pid with grant {adopted.group(2)}: report {json.dumps({k: report[k] for k in ('scanned', 'adopted', 'rescheduled', 'fenced', 'errored', 'jobs_closed', 'duration_s')})};"
          f" its launches [K1, K1-LSE, K2, K3] {before} at the promotion, "
          f"{after} after, {got} in all ({steps} steps, {TRIALS} "
          f"evaluates); its calls walked to the promoted leader: "
          f"{[w[0] for w in walks]}; job STOPPED in {job_s:.1f} s with "
          f"scores {[round(t['score'], 4) for t in trials]}; "
          f"{len(failed)} client calls failed after ready; card memory: "
          f"before the stop {mem_before}; after the adoption {mem_adopted};"
          f" after the trial's end {mem_after}; card {card}", flush=True)
    print(f"ha: 18a in {time.perf_counter() - t_phase:.1f} s (the standby "
          f"exited {standby.returncode} on SIGTERM)", flush=True)
    return got, job["id"]


def ha_restart(card: str, env: dict, logs: Path, store: str,
               sizes: list) -> list:
    """18b: an admin without HA serves 18a's job (one ViT-B/16 replica, a
    serving child), is SIGKILLed and booted again on its port; recovery
    (and the child's own watchdog) leave no replica of the dead admin, the
    job terminal; the client redeploys and the same images get the same
    answers. Returns each kernel's launches in the redeployed replica."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database

    port = _free_port()
    plain = {**env, "RAFIKI_ADMIN_PORT": str(port)}
    argv = [sys.executable, "-m", "rafiki_tpu_torch.admin"]
    t_phase = time.perf_counter()
    admin, banner, boot_s = _ha_proc(plain, logs / "plain.log", argv)
    db = Database(store)  # reads only
    rng = np.random.default_rng(SEED + 18)
    images = rng.standard_normal((HA_IMAGES, 224, 224, 3)).astype(np.float32)
    chunk = max(sizes)
    try:
        c = Client("127.0.0.1", port, timeout_s=HA_WAIT_S)
        c.wait_until_admin_ready(timeout_s=HA_WAIT_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        t0 = time.perf_counter()
        inf = c.create_inference_job("ha")
        deploy_s = time.perf_counter() - t0
        require(len(inf["workers"]) == 1, f"replicas {inf['workers']}")
        old_sid = inf["workers"][0]["service_id"]

        def answers(client):
            return np.concatenate([np.asarray(client.predict(
                "ha", images[i:i + chunk].tolist()))
                for i in range(0, HA_IMAGES, chunk)])

        first = answers(c)
        old_pid = db.get_service(old_sid)["pid"]
        # the dead admin's rings, by its broker's prefix (its serving
        # child's environment): never a name another run made
        with open(f"/proc/{old_pid}/environ", "rb") as f:
            (prefix,) = [e.split(b"=", 1)[1].decode()
                         for e in f.read().split(b"\0")
                         if e.startswith(b"RAFIKI_BROKER_PREFIX=")]
        shm_before = _shm_files(prefix + "-")
        require(bool(shm_before), f"no /dev/shm/{prefix}-* ring")
        mem_before = _card_mib()
        gone = []

        def watch():  # when the dead admin's serving child exits
            while _running(old_pid):
                time.sleep(0.02)
            gone.append(time.perf_counter())

        watcher = threading.Thread(target=watch, daemon=True)
        t_kill = time.perf_counter()
        admin.send_signal(signal.SIGKILL)
        watcher.start()
        admin.wait(timeout=60)
        admin, banner2, reboot_s = _ha_proc(plain, logs / "plain.log", argv)
        c.wait_until_admin_ready(timeout_s=HA_WAIT_S)
        t_ready = time.perf_counter()
        watcher.join(timeout=120)
        require(bool(gone), "the dead admin's serving child lives on")
        exited = gone[0]
        mem_gone = _card_mib()
        report = json.loads((logs / "recovery.json").read_text())
        inf_row = db.get_inference_job(inf["id"])
        svc = db.get_service(old_sid)
        require(not report.get("failed") and inf_row["status"] in (
            "STOPPED", "ERRORED") and svc["status"] in ("STOPPED", "ERRORED"),
            f"after the restart: job {inf_row['status']}, replica "
            f"{svc['status']}, report {report}")
        left = _shm_files(prefix + "-")
        require(set(left) <= set(shm_before), f"rings {sorted(left)} of "
                f"/dev/shm/{prefix}-* appeared after the kill")
        t1 = time.perf_counter()
        inf2 = c.create_inference_job("ha")
        redeploy_s = time.perf_counter() - t1
        (new_sid,) = [w["service_id"] for w in inf2["workers"]]
        second = answers(c)
        c.stop_inference_job("ha")
        _wait_until(lambda: _one_record(logs, new_sid, "kernel launches"),
                    120, "the redeployed replica wrote no exit line")
    finally:
        _stop_proc(admin)
    code = admin.returncode
    require(code == 0, f"the admin exited {code}")
    held = prob_check("ha: the redeploy's answers", second, first)
    (counts,) = _one_record(logs, new_sid, "kernel launches")
    got = [counts[k] for k in COUNTERS]
    require(got[0] > 0 and got[1:] == [0, 0, 0],
            f"the redeployed replica launched {got}")
    fenced = "fenced" in " ".join(report["reasons"])
    print(f"ha: 18b admin without HA {banner!r} in {boot_s:.1f} s; one "
          f"replica deployed in {deploy_s:.1f} s; SIGKILL, then booted "
          f"again on port {port} in {reboot_s:.1f} s ({banner2!r}), ready "
          f"{t_ready - t_kill:.1f} s after the kill; the dead admin's "
          f"serving child (pid {old_pid}) gone {exited - t_kill:.2f} s "
          f"after the kill ("
          + ("fenced by recovery" if fenced else
             "its own watchdog: its parent died, so it stopped before "
             "the reboot's recovery ran")
          + f"), its row {svc['status']}, the job {inf_row['status']}; "
          f"recovery report {json.dumps({k: report[k] for k in ('scanned', 'adopted', 'fenced', 'closed', 'errored', 'jobs_closed', 'duration_s')})},"
          f" reasons {report['reasons']}; /dev/shm left by the dead admin "
          f"(/dev/shm/{prefix}-*): {sum(left.values())} bytes in "
          f"{len(left)} rings of the {len(shm_before)} it held (as in JAX, "
          f"the next boot leaves them; removed here); card memory before "
          f"the kill {mem_before}, after the child's exit {mem_gone}; the "
          f"redeploy in {redeploy_s:.1f} s, its {HA_IMAGES} answers against"
          f" the first: {held}; K1 {got[0]} in the new replica; card {card}",
          flush=True)
    for name in left:
        (Path("/dev/shm") / name).unlink(missing_ok=True)
    print(f"ha: 18b in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return got


def ha_phase(card: str, uris: dict) -> list:
    """Phase 18: 18a then 18b; each kernel's launches on the phase's path
    (the children's exit lines), in ``KERNEL_NAMES`` order."""
    t0 = time.perf_counter()
    work = WORK / "ha"
    logs = work / "logs"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    logs.mkdir(parents=True)
    ring, sizes = choose_ring()
    store = str(work / "store.sqlite3")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAFIKI_")}
    env.update({"PYTHONPATH": os.pathsep.join(
                    p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                    if p),
                "RAFIKI_WORKDIR": str(work),
                "RAFIKI_LOGS_DIR": str(logs), "RAFIKI_DB_PATH": store,
                "RAFIKI_PLACEMENT": "process",
                "RAFIKI_SHM_RING_BYTES": str(ring),
                "INFERENCE_MAX_BEST_TRIALS": "1",
                "SERVICE_DEPLOY_TIMEOUT_S": str(HA_WAIT_S)})
    train, _ = ha_failover(card, uris, env, logs, store)
    serve = ha_restart(card, env, logs, store, sizes)
    counts = [a + b for a, b in zip(train, serve)]
    print(f"ha: phase 18 in {time.perf_counter() - t0:.1f} s; launches on "
          f"its path {counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 19: hosts and agents
# ---------------------------------------------------------------------------

HOSTS_KEY = "chip-smoke-fleet-key"
#: the admin's heartbeat of each agent; DOWN after 3 misses in a row
#: (``RAFIKI_AGENT_DOWN_THRESHOLD``'s default)
HOSTS_HEARTBEAT_S = 0.5
HOSTS_IMAGES = 8    # 19b-d's requests: 8 images as JSON
HOSTS_TIMED = 3     # relayed requests of 1 image timed, one after another
HOSTS_WAIT_S = 600  # any wait of the phase (a job, a boot, a deploy)
_AGENT_READY = "rafiki_tpu_torch agent on http://"


def _stamp(line: str) -> float:
    """The wall-clock time of a log line in the port's logging format
    (``LEVEL:YYYY-MM-DD HH:MM:SS,mmm:...``)."""
    import datetime

    m = re.match(r"\w+:(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})", line)
    require(m is not None, f"no time stamp in {line!r}")
    return datetime.datetime.strptime(
        m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()


def _log_line(log: Path, pattern: str, after: int = 0):
    """The first line of ``log`` past byte ``after`` matching
    ``pattern``, or None."""
    if not log.exists():
        return None
    text = log.read_bytes()[after:].decode(errors="replace")
    return next((ln for ln in text.splitlines() if re.search(pattern, ln)),
                None)


def _ppid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _agents_of(sids: list, agents: dict, kind: str) -> dict:
    """{service id: the address of the agent running it}, from each live
    agent's ``/inventory``; every one must be there, a child of that
    agent's process (never of the admin: no local fallback)."""
    from rafiki_tpu_torch.utils.agent_http import call_agent

    where = {}
    for addr, proc in agents.items():
        if proc.poll() is not None:
            continue
        inv = call_agent(addr, "GET", "/inventory", key=HOSTS_KEY,
                         timeout_s=30)
        for e in inv["services"]:
            if e["service_id"] in sids:
                require(e["service_type"] == kind and e["pid"]
                        and _ppid(e["pid"]) == proc.pid,
                        f"{kind} {e['service_id'][:8]} on {addr}: {e}, "
                        f"the agent's pid {proc.pid}")
                where[e["service_id"]] = addr
    require(sorted(where) == sorted(sids), f"{kind} services {sids} not all "
            f"on the agents' inventories: {where}")
    return where


def _start_agent(env: dict, logs: Path, i: int, chips: str,
                 port: int) -> tuple:
    return _ha_start({**env, "RAFIKI_AGENT_CHIPS": chips,
                      "RAFIKI_AGENT_PORT": str(port)},
                     logs / f"agent{i}.log",
                     [sys.executable, "-m", "rafiki_tpu_torch.placement.agent"],
                     session=True)


def _agent_up(handle: tuple) -> tuple:
    """(process, address, seconds to its ready line, the line)."""
    proc, line, boot_s = _ha_line(handle)
    require(line.startswith(_AGENT_READY), f"agent: {line!r}")
    return proc, line[len(_AGENT_READY):].split()[0], boot_s, line


def hosts_observability(c, addrs: list, logs: Path,
                        image: np.ndarray) -> tuple:
    """19b's observability (phase 20's, over the relay): one sampled
    one-image request at the job's door (``RAFIKI_PREDICTOR_PORTS=1``)
    whose exemplar holds the agents' spans grafted into the door's tree
    (the worker-side spans come only from an agent's answer), and each
    live agent's ``/metrics`` parsed. Returns the two report strings."""
    from rafiki_tpu_torch.utils import trace as rtrace

    inf = c.get_inference_job("hosts")
    door = f"http://{inf['predictor_host']}:{inf['predictor_port']}"
    body, headers = request_body("npy", image)
    trace_id = "a9e17" * 6 + "00"
    req = urllib.request.Request(door + "/predict", data=body, method="POST",
                                 headers={**headers,
                                          "Authorization":
                                              f"Bearer {c._token}",
                                          rtrace.TRACE_HEADER:
                                              f"{trace_id};s=1"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        echoed = resp.headers.get(rtrace.TRACE_HEADER)
        resp.read()
    wall = time.perf_counter() - t
    require(echoed == f"{trace_id};s=1", f"19b: the door echoed {echoed!r}")
    ex = _wait_until(
        lambda: _exemplars(logs / "predict_exemplars.jsonl").get(trace_id),
        30, "19b: no exemplar of the sampled request")
    names = [sp["name"] for sp in ex["spans"]]
    missing = [ph for ph in TRACE_PHASES if ph not in names]
    require(not missing, f"19b: the relayed request's tree lacks {missing} "
            f"(the agents' spans not grafted): {names}")
    total = sum(sp["duration_s"] for sp in ex["spans"])
    scraped = {}
    for a in addrs:
        _, samples, metric_names = _scrape(f"http://{a}/metrics")
        require("rafiki_queue_rejected_total" in metric_names
                and "rafiki_wire_errors_total" in metric_names,
                f"19b: agent {a}'s /metrics {sorted(metric_names)}")
        scraped[a] = (len(metric_names), len(samples))
    return (f"{len(names)} spans {sorted(set(names))} summing to "
            f"{total * 1e3:.1f} ms of a {wall * 1e3:.1f}-ms request (door "
            f"e2e {ex['e2e_s'] * 1e3:.1f} ms)",
            f"(metrics, samples) by agent {scraped}")


def hosts_phase(card: str, uris: dict) -> list:
    """Phase 19: two agent processes and an admin in hosts mode over one
    store. 19a a ViT-B/16 job placed on both agents; 19b its trials served
    from the agents through the relay; 19c an agent SIGKILLed under
    traffic; 19d the admin SIGKILLed and booted again, adopting the
    surviving replica. Returns each kernel's launches in the agents'
    children (their exit lines)."""
    import shutil

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.utils.agent_http import AgentHTTPError, call_agent

    t_phase = time.perf_counter()
    work = WORK / "hosts"
    logs = work / "logs"
    if work.exists():
        shutil.rmtree(work)
    logs.mkdir(parents=True)
    ring, sizes = choose_ring()
    chunk = max(sizes)
    store = str(work / "store.sqlite3")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAFIKI_")}
    env.update({"PYTHONPATH": os.pathsep.join(
                    p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                    if p),
                "RAFIKI_WORKDIR": str(work), "RAFIKI_LOGS_DIR": str(logs),
                "RAFIKI_DB_PATH": store, "RAFIKI_SHM_RING_BYTES": str(ring),
                "RAFIKI_AGENT_KEY": HOSTS_KEY,
                "SERVICE_DEPLOY_TIMEOUT_S": str(HOSTS_WAIT_S)})
    cards = torch.cuda.device_count()
    # one card: both agents list it and share it; on several, disjoint sets
    chip_sets = (["0", "0"] if cards < 2 else
                 [",".join(str(c) for c in range(i, cards, 2))
                  for i in (0, 1)])
    admin_port = _free_port()
    ports = [_free_port() for _ in chip_sets]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    agent_env = {**env, "RAFIKI_ADMIN_ADDR": f"127.0.0.1:{admin_port}"}
    admin_env = {**env, "RAFIKI_PLACEMENT": "hosts",
                 "RAFIKI_AGENTS": ",".join(addrs),
                 "RAFIKI_ADMIN_PORT": str(admin_port),
                 "RAFIKI_ADMIN_HA": "1",
                 "RAFIKI_ADMIN_LEASE_TTL_S": str(HA_TTL_S),
                 "RAFIKI_AGENT_HEARTBEAT_S": str(HOSTS_HEARTBEAT_S),
                 "INFERENCE_MAX_BEST_TRIALS": "2",
                 # the job's own door too: 19b's sampled request
                 "RAFIKI_PREDICTOR_PORTS": "1"}
    admin_argv = [sys.executable, "-m", "rafiki_tpu_torch.admin"]
    admin_log = logs / "admin.log"
    agents: dict = {}  # address -> process
    started: list = []  # every process the phase starts, for the teardown
    admin = code = None
    rng = np.random.default_rng(SEED + 19)
    images = rng.standard_normal(
        (HOSTS_IMAGES, 224, 224, 3)).astype(np.float32)
    try:
        # ---- the agents and the admin boot together, on a store made
        # first (two processes making one SQLite file at once may both
        # find it locked as they switch it to WAL) ----
        Database(store).close()
        handles = [_start_agent(agent_env, logs, i, chips, port)
                   for i, (chips, port) in enumerate(zip(chip_sets, ports))]
        booting = _ha_start(admin_env, admin_log, admin_argv)
        started += [h[0] for h in handles] + [booting[0]]
        lines = []
        for addr, handle in zip(addrs, handles):
            proc, got, boot_s, line = _agent_up(handle)
            require(got == addr, f"agent at {got}, asked {addr}")
            agents[addr] = proc
            lines.append(f"{line!r} in {boot_s:.1f} s")
        admin, banner, admin_s = _ha_line(booting)
        require(f"admin on http://127.0.0.1:{admin_port}" in banner
                and "placement=HostAgentPlacementManager" in banner, banner)
        # every agent UP on the admin's heartbeat before a placement: one
        # that booted after the admin may have been marked DOWN first
        time.sleep(3 * HOSTS_HEARTBEAT_S)
        _wait_until(lambda: all(
            _log_line(admin_log, rf"agent {re.escape(a)} DOWN") is None
            or _log_line(admin_log, rf"agent {re.escape(a)} recovered")
            for a in addrs), 60, "an agent stayed DOWN on the admin's "
            "heartbeat")
        print(f"hosts: agents {lines} (chips {chip_sets} of {cards} "
              f"card(s)); admin {banner!r} in {admin_s:.1f} s, heartbeat "
              f"{HOSTS_HEARTBEAT_S:g} s; card {card}", flush=True)
        c = Client("127.0.0.1", admin_port, timeout_s=HOSTS_WAIT_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        db = Database(store)  # reads only

        # ---- 19a: a train job placed on both agents ----
        names = ["HostsViTA", "HostsViTB"]
        for name in names:
            c.create_model(name, "IMAGE_CLASSIFICATION", twin_template(
                name, "FloatKnob(1e-5, 1e-3, is_exp=True)", 64, 1,
                checkpoint=False), name)
        t0 = time.perf_counter()
        c.create_train_job("hosts", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": 1,
                                                 "CHIP_COUNT": 2},
                           models=names)
        job = c.get_train_job("hosts")
        train_sids = [w["service_id"] for w in job["workers"]]
        trained_on = _agents_of(train_sids, agents, "TRAIN")
        require(len(train_sids) == 2
                and sorted(trained_on.values()) == sorted(addrs),
                f"19a placements {trained_on}")
        job = c.wait_until_train_job_stopped("hosts",
                                             timeout_s=HOSTS_WAIT_S)
        job_s = time.perf_counter() - t0
        trials = c.get_trials_of_train_job("hosts")
        require(job["status"] == "STOPPED" and len(trials) == 2
                and all(t["status"] == "COMPLETED"
                        and np.isfinite(t["score"]) for t in trials),
                f"19a job {job['status']}, trials "
                f"{[(t['status'], t['score']) for t in trials]}")
        steps = TRAIN_IMAGES // 64
        train_counts = []
        for sid in train_sids:
            (rec,) = _wait_until(
                lambda: _one_record(logs, sid, "kernel launches"), 120,
                f"train child {sid[:8]} wrote no exit line")
            got = [rec[k] for k in COUNTERS]
            require(got == [DEPTH] + [DEPTH * steps] * 3,
                    f"train child {sid[:8]} on {trained_on[sid]} launched "
                    f"{got}, expected {[DEPTH] + [DEPTH * steps] * 3}")
            train_counts.append(got)
        print(f"hosts: 19a placements (least loaded): "
              f"{ {sid[:8]: a for sid, a in trained_on.items()} }; job "
              f"STOPPED in {job_s:.1f} s, scores "
              f"{[round(t['score'], 4) for t in trials]}; launches [K1, "
              f"K1-LSE, K2, K3] in each agent's train child {train_counts} "
              f"(1 evaluate, {steps} steps); card {card}", flush=True)

        # ---- 19b: serving through the agents' relay ----
        t0 = time.perf_counter()
        inf = c.create_inference_job("hosts")
        deploy_s = time.perf_counter() - t0
        serve_sids = [w["service_id"] for w in inf["workers"]]
        served_on = _agents_of(serve_sids, agents, "INFERENCE")
        require(sorted(set(served_on.values())) == sorted(addrs),
                f"19b replicas {served_on}")

        def answers():
            return np.concatenate([np.asarray(c.predict(
                "hosts", images[i:i + chunk].tolist()))
                for i in range(0, HOSTS_IMAGES, chunk)])

        first = answers()
        relays = {a: call_agent(a, "GET", "/inventory", key=HOSTS_KEY,
                                timeout_s=30)["relays"] for a in addrs}
        require(all(r["binary"] > 0 and r["json"] == 0
                    for r in relays.values()),
                f"19b relays {relays}: not all binary frames")
        lat = []
        for _ in range(HOSTS_TIMED):
            t = time.perf_counter()
            c.predict("hosts", images[:1].tolist())
            lat.append(time.perf_counter() - t)
        relayed_p50 = statistics.median(lat) * 1e3
        # each trial's own forward in this process (its template, its
        # parameters, the kernels), the admin's ensemble their mean
        refs = {}
        for t in trials:
            row = db.get_trial(t["id"])
            model_row = db.get_model(row["model_id"])
            m = load_model_class(model_row["model_file_bytes"],
                                 model_row["model_class"])(**row["knobs"])
            m.load_parameters(load_params(read_artifact(
                row["params_file_path"])))
            refs[t["id"]] = np.asarray(m.predict(images))
            m.destroy()
        require(first.shape == (HOSTS_IMAGES, refs[trials[0]["id"]].shape[1])
                and bool(np.isfinite(first).all()), f"19b answers "
                f"{first.shape}")
        held = prob_check("hosts: 19b relayed answers", first,
                          sum(refs.values()) / len(refs))
        traced, scraped = hosts_observability(c, addrs, logs, images[:1])
        phase5 = STACK_P50.get(1)
        print(f"hosts: 19b the inference job RUNNING in {deploy_s:.1f} s, "
              f"replicas on the agents "
              f"{ {sid[:8]: a for sid, a in served_on.items()} } (each a "
              f"child of its agent's process); {HOSTS_IMAGES} images "
              f"through the admin door, FleetBroker, HttpWorkerQueue and "
              f"/predict_relay: relays by agent {relays} (binary frames: "
              f"yes); against the trials' own forward in this process "
              f"(their ensemble): {held}; relayed p50 of 1 image "
              f"{relayed_p50:.1f} ms ({HOSTS_TIMED} requests) beside phase "
              f"5's admin door "
              + (f"{phase5:.1f} ms" if phase5 is not None
                 else "(phase 5 not run)") + f"; a sampled request at the "
              f"job's door: {traced}; the agents' /metrics: {scraped}; card "
              f"{card}", flush=True)

        # ---- 19c: an agent SIGKILLed under traffic ----
        victim = addrs[1]
        dead = [s for s in serve_sids if served_on[s] == victim]
        live_trials = {db.get_inference_job_worker(s)["trial_id"]
                       for s in serve_sids if served_on[s] != victim}
        results = []  # (wall start, wall end, error or None)
        stop_load = threading.Event()

        def load():
            one = images[:1].tolist()
            while not stop_load.is_set():
                t = time.time()
                try:
                    c.predict("hosts", one)
                    results.append((t, time.time(), None))
                except Exception as e:  # counted and reported
                    results.append((t, time.time(), repr(e)))
                time.sleep(0.02)

        loader = threading.Thread(target=load, daemon=True)
        mark = admin_log.stat().st_size
        loader.start()
        _wait_until(lambda: len(results) >= 5, 60, "19c: no load")
        t_kill = time.time()
        os.killpg(agents[victim].pid, signal.SIGKILL)
        agents[victim].wait(timeout=60)
        down = _wait_until(lambda: _log_line(
            admin_log, rf"agent {re.escape(victim)} DOWN", mark), 60,
            "19c: no DOWN verdict")
        t_down = _stamp(down)
        evicted = _wait_until(lambda: _log_line(
            admin_log, rf"evicted \d+ relay queue\(s\) of dead agent "
            rf"{re.escape(victim)}", mark), 60, "19c: no eviction")
        _wait_until(lambda: all(db.get_service(s)["status"] == "ERRORED"
                                for s in dead), 60,
                    f"19c: the dead agent's replicas "
                    f"{[db.get_service(s)['status'] for s in dead]}")
        # the agent comes back on its address (a new process) while the
        # load goes on past the verdict
        mark_back = admin_log.stat().st_size
        restarting = _start_agent(agent_env, logs, 2, chip_sets[1], ports[1])
        started.append(restarting[0])
        time.sleep(2.0)
        stop_load.set()
        loader.join(timeout=60)
        before = [r for r in results if r[0] < t_down]
        after = [r for r in results if r[0] >= t_down]
        require(after and not any(r[2] for r in after),
                f"19c: requests failed after the DOWN verdict: "
                f"{[r[2] for r in after if r[2]][:3]}")
        survivor = answers()
        held_c = prob_check("hosts: 19c the survivor's answers", survivor,
                            sum(refs[t] for t in live_trials)
                            / len(live_trials))
        print(f"hosts: 19c agent {victim} SIGKILLed (its process group): "
              f"DOWN {t_down - t_kill:.2f} s after the kill; "
              f"{evicted.split(': ', 1)[1]!r}; its replicas "
              f"{[s[:8] for s in dead]} ERRORED; requests failed before the "
              f"verdict {sum(1 for r in before if r[2])} of {len(before)}, "
              f"after it {sum(1 for r in after if r[2])} of {len(after)}; "
              f"the survivor's {HOSTS_IMAGES} answers against its trial's "
              f"forward: {held_c}; the agent started again on its "
              f"address; card {card}", flush=True)

        proc, _, back_s, _ = _agent_up(restarting)
        agents[victim] = proc
        _wait_until(lambda: _log_line(
            admin_log, rf"agent {re.escape(victim)} recovered", mark_back),
            60, "19d: the restarted agent never rejoined")

        # ---- 19d: the admin SIGKILLed and booted again ----
        survivors = [s for s in serve_sids if s not in dead]
        pids = {s: db.get_service(s)["pid"] for s in survivors}

        def serving_rows():
            return sorted(r["id"] for r in db.get_services()
                          if r["service_type"] == "INFERENCE")

        rows_before = serving_rows()
        t_kill = time.perf_counter()
        admin.send_signal(signal.SIGKILL)
        admin.wait(timeout=60)
        require(all(p.poll() is None for p in agents.values()),
                "19d: an agent died with the admin")
        admin, banner2, reboot_s = _ha_proc(admin_env, admin_log,
                                            admin_argv)
        started.append(admin)
        c.wait_until_admin_ready(timeout_s=HOSTS_WAIT_S)
        t_ready = time.perf_counter()
        report = json.loads((logs / "recovery-e2.json").read_text())
        require(report["adopted"] >= 1 and report["errored"] == 0
                and report["agents_probed"] == 2
                and report["agents_unreachable"] == 0
                and not report.get("failed"),
                f"19d recovery report {report}")
        require(all(p.poll() is None for p in agents.values()),
                "19d: an agent died across the admin's restart")
        adopted_on = _agents_of(survivors, agents, "INFERENCE")
        require({s: db.get_service(s)["pid"] for s in survivors} == pids
                and serving_rows() == rows_before,
                "19d: a serving child was started again")
        again = answers()
        held_d = prob_check("hosts: 19d answers after the restart", again,
                            survivor)
        # the ex-leader's epoch is refused by the agents
        refused = []
        for addr in addrs:
            try:
                call_agent(addr, "POST", f"/services/{survivors[0]}/stop",
                           {"wait": False}, key=HOSTS_KEY, timeout_s=30,
                           epoch=1)
                refused.append(200)
            except AgentHTTPError as e:
                refused.append(e.code)
        require(refused == [412, 412], f"19d: epoch-1 stops answered "
                f"{refused}")
        require(db.get_service(survivors[0])["status"] == "RUNNING",
                "19d: the stale stop landed")
        print(f"hosts: 19d (the restarted agent ready in {back_s:.1f} s and "
              f"rejoined) admin SIGKILLed and booted again "
              f"({banner2!r}) in {reboot_s:.1f} s, ready "
              f"{t_ready - t_kill:.1f} s after the kill; the agents lived "
              f"on; recovery report "
              f"{json.dumps({k: report[k] for k in ('scanned', 'adopted', 'rescheduled', 'fenced', 'errored', 'agents_probed', 'agents_unreachable', 'duration_s')})};"
              f" replicas adopted on "
              f"{ {s[:8]: a for s, a in adopted_on.items()} } with the same "
              f"pids (no new serving child); the same {HOSTS_IMAGES} "
              f"images: {held_d}; a stop carrying epoch 1 answered "
              f"{refused} by the agents; card {card}", flush=True)
        c.stop_inference_job("hosts")
        serve_counts = []
        for sid in serve_sids:
            (rec,) = _wait_until(
                lambda: _one_record(logs, sid, "kernel launches"), 120,
                f"serving child {sid[:8]} wrote no exit line")
            got = [rec[k] for k in COUNTERS]
            require(got[0] > 0 and got[0] % DEPTH == 0
                    and got[1:] == [0, 0, 0],
                    f"serving child {sid[:8]} launched {got}")
            serve_counts.append(got)
    finally:
        if admin is not None:
            code = _stop_proc(admin)
        for proc in started:
            _stop_proc(proc)
    require(code == 0, f"the admin exited {code}")
    codes = [p.returncode for p in agents.values()]
    require(codes == [0, 0], f"the agents exited {codes}")
    counts = [sum(c[i] for c in train_counts + serve_counts)
              for i in range(4)]
    print(f"hosts: launches in the serving children (warm-up and requests) "
          f"{serve_counts}; phase 19 in {time.perf_counter() - t_phase:.1f}"
          f" s; launches on its path {counts}; the agents exited {codes}",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 20: observability (trial traces, the profile, request traces,
# /metrics, /fleet/health)
# ---------------------------------------------------------------------------

#: the door-to-worker phases of a sampled predict over the shm hop
TRACE_PHASES = ("admission_wait", "queue_wait", "codec_decode",
                "batch_assembly", "model_forward", "respond")
#: the spans a trial's worker saves
TRIAL_SPANS = {"propose", "train", "evaluate", "persist_params"}
#: the metric names the JAX package publishes (its tests/test_metrics.py)
PUBLISHED = (
    "rafiki_admission_admitted_total", "rafiki_admission_shed_total",
    "rafiki_admission_inflight", "rafiki_admission_ewma_query_seconds",
    "rafiki_request_seconds", "rafiki_queue_expired_total",
    "rafiki_queue_rejected_total", "rafiki_predictor_hedges_total",
    "rafiki_predictor_hedges_suppressed_total",
    "rafiki_predictor_trials_shed_total",
    "rafiki_predictor_requests_shed_total", "rafiki_wire_errors_total",
    "rafiki_phase_seconds")
#: /fleet/health's sections, as the JAX admin's
HEALTH_SECTIONS = ("placement", "agents", "agents_down", "chaos_active",
                   "recovery", "ha", "autoscaler", "warm_pool", "rollouts",
                   "drift", "serving", "training")
OBS_REQUESTS = 8
#: a sampled request's spans against its wall time: at least this share
#: of the door's own end-to-end time, at most this multiple of the
#: client's (JAX's drill, tests/test_metrics.py)
SPAN_SUM_LOW, SPAN_SUM_HIGH = 0.3, 1.3


def _kernel_of(name: str):
    """The KERNEL_NAMES entry a profiled CUDA kernel's name is, or None
    (demangled, ``flash_fwd_wgmma_kernel<64, true>``, or mangled,
    ``..._kernelILi64ELb1EE...``)."""
    if "flash_bwd_dkv" in name:
        return "flash_bwd_dkv"
    if "flash_bwd_dq" in name:
        return "flash_bwd_dq"
    if "flash_fwd" in name:
        train = re.search(r",\s*true>|Lb1E", name)
        serve = re.search(r",\s*false>|Lb0E", name)
        require(bool(train) != bool(serve),
                f"20a: cannot tell K1 from K1-LSE in {name!r}")
        return "flash_fwd_lse" if train else "flash_fwd"
    return None


def _profiled_kernels(path: Path) -> dict:
    """{kernel name: (launches, device ms summed)} of the attention
    kernels in a Chrome trace, and the count of every CUDA kernel."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") == "kernel"]
    out = {name: [0, 0.0] for name in KERNEL_NAMES}
    for e in gpu:
        kernel = _kernel_of(e.get("name", ""))
        if kernel is not None:
            out[kernel][0] += 1
            out[kernel][1] += float(e.get("dur", 0.0)) / 1e3
    return {k: tuple(v) for k, v in out.items()}, len(gpu)


def _metric_names(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _scrape(url: str) -> tuple:
    """(the exposition's text, its samples, its metric names)."""
    from rafiki_tpu_torch.utils.metrics import parse_prometheus

    with urllib.request.urlopen(url, timeout=30) as resp:
        require(resp.status == 200
                and resp.headers["Content-Type"].startswith("text/plain"),
                f"{url} answered {resp.status} "
                f"{resp.headers['Content-Type']}")
        text = resp.read().decode()
    return text, parse_prometheus(text), _metric_names(text)


def _exemplars(path: Path) -> dict:
    """{trace id: exemplar} of a door's exemplar file."""
    if not path.exists():
        return {}
    return {ex["trace_id"]: ex for ex in
            (json.loads(line) for line in path.read_text().splitlines()
             if line.strip())}


def observability_phase(card: str, uris: dict, entries: dict) -> list:
    """Phase 20. 20a: a one-trial ViT-B/16 job (1 epoch of 512 images at
    batch 64) through the admin under ``RAFIKI_PROFILE=1``: the trial's
    Chrome trace holds K1-LSE, K2 and K3 by name, as many times as their
    wrappers launched them, and ``get_trial_trace`` its four spans. 20b:
    the trial served under process placement with
    ``RAFIKI_TRACE_SAMPLE=1``: 8 one-image requests with an
    ``X-Rafiki-Trace`` header at the job's door, over the shm rings, each
    one span tree door -> worker child -> door; K1 12 a forward in the
    child. 20c: ``/metrics`` of the admin's door and the job's door, and
    ``/fleet/health``. Returns each kernel's launches on this path (this
    process's counters in 20a, the serving child's exit line in 20b)."""
    import shutil

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer
    from rafiki_tpu_torch.utils import trace as rtrace

    t_phase = time.perf_counter()
    work = WORK / "observability"
    logs = work / "logs"
    if work.exists():
        shutil.rmtree(work)
    logs.mkdir(parents=True)
    store = str(work / "store.sqlite3")
    kernels = _kernels()
    steps = TRAIN_IMAGES // 64

    # ---- 20a: a profiled trial through the admin ----
    with _Env(RAFIKI_PROFILE="1", RAFIKI_WORKDIR=str(work),
              RAFIKI_LOGS_DIR=str(logs)):
        admin = Admin(db=Database(store), params_dir=str(work / "params"))
        server = AdminServer(admin).start()
        try:
            c = Client("127.0.0.1", server.port, timeout_s=900)
            c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
            c.create_model("obs", "IMAGE_CLASSIFICATION", twin_template(
                "ObsViT", "FloatKnob(1e-5, 1e-3, is_exp=True)", 64, 1,
                checkpoint=False), "ObsViT")
            for kernel in kernels:
                kernel.launches = 0
            t0 = time.perf_counter()
            c.create_train_job("obs", "IMAGE_CLASSIFICATION", uris["train"],
                               uris["test"], budget={"MODEL_TRIAL_COUNT": 1,
                                                     "CHIP_COUNT": 1})
            job = c.wait_until_train_job_stopped("obs", timeout_s=900,
                                                 poll_s=0.05)
            torch.cuda.synchronize()
            job_s = time.perf_counter() - t0
            train_counts = [k.launches for k in kernels]
            (trial,) = c.get_trials_of_train_job("obs")
            spans = c.get_trial_trace(trial["id"])
        finally:
            server.stop()
            admin.shutdown()
    require(job["status"] == "STOPPED" and trial["status"] == "COMPLETED",
            f"20a job {job['status']}, trial {trial['status']}")
    require({s["name"] for s in spans} == TRIAL_SPANS
            and all(s["depth"] == 0 for s in spans),
            f"20a: the trial's trace "
            f"{[(s['name'], s['depth']) for s in spans]}")
    require(train_counts[1:] == [DEPTH * steps] * 3,
            f"20a: the wrappers launched {train_counts}, expected K1-LSE, "
            f"K2, K3 {DEPTH * steps} each ({steps} steps)")
    profiles = list((logs / "profiles").glob(f"trial-{trial['id']}-*.json"))
    require(len(profiles) == 1, f"20a: profiles {profiles}")
    t = time.perf_counter()
    profiled, gpu_events = _profiled_kernels(profiles[0])
    read_s = time.perf_counter() - t
    require(gpu_events > 0, "20a: the profile holds no CUDA kernel: the "
            "capture had no CUDA activity")
    for name, launched in zip(KERNEL_NAMES[1:], train_counts[1:]):
        require(profiled[name][0] == launched,
                f"20a: the profile holds {profiled[name][0]} {name} "
                f"kernels, its wrapper launched {launched}")
    require(profiled["flash_fwd"][0] == 0,
            f"20a: K1 {profiled['flash_fwd'][0]} times in the train span")
    train_s = next(s["duration_s"] for s in spans if s["name"] == "train")
    per = "; ".join(
        f"{name} x{profiled[name][0]} {profiled[name][1]:.3f} ms summed, "
        f"{profiled[name][1] / max(profiled[name][0], 1):.4f} ms a launch "
        f"(phase "
        f"2: {entries[name]['ms']:.4f} ms at B=64, CUDA events)"
        for name in KERNEL_NAMES[1:])
    print(f"observability: 20a a 1-trial ViT-B/16 job under RAFIKI_PROFILE=1 "
          f"STOPPED in {job_s:.1f} s; the trial's trace "
          f"{sorted((s['name'], round(s['duration_s'], 3)) for s in spans)}"
          f"; its Chrome trace {profiles[0].name} "
          f"({profiles[0].stat().st_size / 1e6:.1f} MB, {gpu_events} CUDA "
          f"kernels over the {train_s:.2f}-s train span, read in "
          f"{read_s:.1f} s): {per}; the wrappers' counts {train_counts} "
          f"[K1 (its evaluate), K1-LSE, K2, K3]; card {card}", flush=True)

    # ---- 20b: the trial served under process placement, traced ----
    ring, _ = choose_ring()
    exemplar_file = logs / "predict_exemplars.jsonl"
    rng = np.random.default_rng(SEED + 20)
    images = rng.standard_normal((OBS_REQUESTS, 224, 224, 3)).astype(
        np.float32)
    cap = config.PREDICT_MAX_BATCH_SIZE
    buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
    with _Env(RAFIKI_PLACEMENT="process", RAFIKI_WORKDIR=str(work),
              RAFIKI_LOGS_DIR=str(logs), RAFIKI_SHM_RING_BYTES=str(ring),
              RAFIKI_TRACE_SAMPLE="1", RAFIKI_PREDICTOR_PORTS="1"):
        admin = Admin(db=Database(store), params_dir=str(work / "params"))
        server = AdminServer(admin).start()
        sid = None
        try:
            require(isinstance(admin.placement, ProcessPlacementManager),
                    f"20b placement {type(admin.placement).__name__}")
            c = Client("127.0.0.1", server.port, timeout_s=900)
            c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
            token = admin.authenticate_user(
                config.SUPERADMIN_EMAIL,
                config.SUPERADMIN_PASSWORD)["token"]
            t0 = time.perf_counter()
            inf = c.create_inference_job("obs")
            deploy_s = time.perf_counter() - t0
            (sid,) = [w["service_id"] for w in inf["workers"]]
            inf = c.get_inference_job("obs")
            door = f"http://{inf['predictor_host']}:{inf['predictor_port']}"
            walls, ids = {}, []
            for i in range(OBS_REQUESTS):
                body, headers = request_body("npy", images[i:i + 1])
                trace_id = f"{0xc0ffee00 + i:08x}" * 4
                req = urllib.request.Request(
                    door + "/predict", data=body, method="POST", headers={
                        **headers, "Authorization": f"Bearer {token}",
                        rtrace.TRACE_HEADER: f"{trace_id};s=1"})
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answer = np.load(io.BytesIO(resp.read()),
                                     allow_pickle=False)
                    echoed = resp.headers.get(rtrace.TRACE_HEADER)
                walls[trace_id] = time.perf_counter() - t
                ids.append(trace_id)
                require(echoed == f"{trace_id};s=1",
                        f"20b: the door echoed {echoed!r}")
                # the template's 1000 classes' probabilities
                require(answer.ndim == 2 and answer.shape[0] == 1
                        and bool(np.isfinite(answer).all())
                        and abs(float(answer.sum()) - 1.0) < 1e-2,
                        f"20b answer {answer.shape}, sum {answer.sum()}")
            exemplars = _wait_until(
                lambda: (lambda got: got if all(i in got for i in ids)
                         else None)(_exemplars(exemplar_file)), 30,
                "20b: an exemplar is missing")
            sums = []
            for trace_id in ids:
                ex = exemplars[trace_id]
                names = [sp["name"] for sp in ex["spans"]]
                missing = [ph for ph in TRACE_PHASES if ph not in names]
                require(not missing, f"20b: request {trace_id[:8]}'s tree "
                        f"lacks {missing}: {names}")
                total = sum(sp["duration_s"] for sp in ex["spans"])
                require(SPAN_SUM_LOW * ex["e2e_s"] <= total
                        <= SPAN_SUM_HIGH * walls[trace_id],
                        f"20b: request {trace_id[:8]}'s spans sum to "
                        f"{total:.4f} s against the door's {ex['e2e_s']:.4f}"
                        f" and the client's {walls[trace_id]:.4f}")
                sums.append((total, ex["e2e_s"], walls[trace_id]))
            last = exemplars[ids[-1]]
            tree = "; ".join(f"{sp['name']} {sp['duration_s'] * 1e3:.2f}"
                             for sp in last["spans"])

            # ---- 20c: /metrics on both doors, /fleet/health ----
            _, admin_samples, admin_names = _scrape(
                f"http://127.0.0.1:{server.port}/metrics")
            _, door_samples, door_names = _scrape(door + "/metrics")
            for where, names in (("the admin's door", admin_names),
                                 ("the job's door", door_names)):
                missing = [n for n in PUBLISHED if n not in names]
                require(not missing, f"20c: {where}'s /metrics lacks "
                        f"{missing}")
            label = 'door="predictor:obs"'
            admitted = door_samples.get(
                f"rafiki_admission_admitted_total{{{label}}}")
            served = door_samples.get(
                f"rafiki_request_seconds_count{{{label}}}")
            forwards = door_samples.get(
                'rafiki_phase_seconds_count{phase="model_forward"}')
            require(admitted == served == OBS_REQUESTS
                    and forwards == OBS_REQUESTS,
                    f"20c: the job door's counters admitted {admitted}, "
                    f"served {served}, traced forwards {forwards}")
            health = c.get_fleet_health()
            require(sorted(health) == sorted(HEALTH_SECTIONS),
                    f"20c: /fleet/health sections {sorted(health)}")
            job_row = health["serving"]["jobs"].get(inf["id"])
            require(job_row is not None and job_row["status"] == "ok"
                    and job_row["workers"] == 1,
                    f"20c: /fleet/health's serving job {job_row}")
            require(health["placement"] == "ProcessPlacementManager"
                    and health["ha"] == {"enabled": False}
                    and health["recovery"]["state"] == "ready",
                    f"20c: /fleet/health {health['placement']}, "
                    f"{health['ha']}, {health['recovery']}")
            c.stop_inference_job("obs")
        finally:
            server.stop()
            admin.shutdown()
    (rec,) = _wait_until(lambda: _one_record(logs, sid, "kernel launches"),
                         120, f"20b: serving child {sid[:8]} wrote no exit "
                         "line")
    serve_counts = [rec[k] for k in COUNTERS]
    n_forwards = len(buckets) + OBS_REQUESTS
    require(serve_counts == [DEPTH * n_forwards, 0, 0, 0],
            f"20b: the serving child launched {serve_counts}, expected "
            f"[{DEPTH * n_forwards}, 0, 0, 0] ({len(buckets)} warm-up "
            f"buckets + {OBS_REQUESTS} traced forwards)")
    print(f"observability: 20b the trial served by one child under process "
          f"placement (deployed in {deploy_s:.1f} s, ring {ring >> 20} MiB); "
          f"{OBS_REQUESTS} one-image requests with X-Rafiki-Trace at the "
          f"job's door, each header echoed and each an exemplar whose spans "
          f"hold {list(TRACE_PHASES)}: span sums / door e2e / client wall "
          f"(ms) {[tuple(round(x * 1e3, 2) for x in s) for s in sums]}; the "
          f"last tree (ms): {tree}; the serving child's launches "
          f"{serve_counts} (K1 {DEPTH} a forward: {len(buckets)} warm-up "
          f"buckets + {OBS_REQUESTS} traced); card {card}", flush=True)
    print(f"observability: 20c /metrics parsed on the admin's door "
          f"({len(admin_samples)} samples, {len(admin_names)} metrics) and "
          f"the job's door ({len(door_samples)} samples): every name JAX "
          f"publishes present; the door admitted {admitted:g} and traced "
          f"{forwards:g} forwards; /fleet/health sections "
          f"{sorted(health)}; phase 20 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return [a + b for a, b in zip(train_counts, serve_counts)]


def observability_only() -> None:
    """The dataset, phase 2 (for its kernel times) and phase 20."""
    card = header()
    entries, _ = kernel_phase()
    observability_phase(card, write_train_dataset(), entries)


def hosts_only() -> None:
    """Phase 19 with what it stands on (the dataset): the card's line,
    the kernel build, the dataset, then phase 19."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = header()
    counts = hosts_phase(card, write_train_dataset())
    print(f"chip_smoke: hosts_only passed; launches on phase 19's path "
          f"{counts}", flush=True)


def ha_only() -> None:
    """Phase 18 with what it stands on (the dataset): the card's line,
    the kernel build, the dataset, then phase 18."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = header()
    counts = ha_phase(card, write_train_dataset())
    print(f"chip_smoke: ha_only passed; launches on phase 18's path "
          f"{counts}", flush=True)


def drift_sandbox_only() -> None:
    """Phase 17 with what it stands on (phase 5's store and trials): the
    card's line, the kernel build, the dataset, phase 5, then phase 17."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = header()
    uris = write_train_dataset()
    stack_phase(card, uris, 0.0)
    counts = drift_sandbox_phase(card, uris)
    print(f"chip_smoke: drift_sandbox_only passed; launches on phase 17's "
          f"path {counts}", flush=True)


def fleet_only() -> None:
    """Phase 16 with what it stands on (8a's trials, 8b's LM), and 16d
    on two or more cards: the card's line, the kernel build, phase 8, then
    phase 16."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = header()
    from rafiki_tpu_torch import config

    # one replica a trial, so phase 8's one-card deploy shapes hold on
    # several cards
    with _fleet_sizing(config.INFERENCE_MAX_BEST_TRIALS, 1):
        text_phase(card)
    counts = fleet_phase(card)
    require(counts[0] > 0, "K1 was not launched on the fleet path")
    print(f"chip_smoke: fleet_only passed; K1 launches on the fleet path "
          f"{counts[0]}", flush=True)


def model_parallel_only() -> None:
    """Phase 15 alone (TF32 off, as in ``main``): the card's line, the
    kernel build, then the phase."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_parallel_phase(header())


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


#: set in the run's environment before it starts anything: every process
#: of the run inherits it (the phases' own environments copy it), orphans
#: and processes in sessions of their own included
RUN_MARK = "CHIP_SMOKE_RUN"


def _strays() -> list:
    """Live processes of this run but this one: the run's mark in their
    environment, or this process among their ancestors."""
    me = os.getpid()
    mark = f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    parents, marked = {}, set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                fields = f.read().rsplit(b")", 1)[1].split()
            if fields[0] == b"Z":
                continue
            parents[pid] = int(fields[1])
            with open(f"/proc/{pid}/environ", "rb") as f:
                if mark in f.read().split(b"\0"):
                    marked.add(pid)
        except (OSError, IndexError, ValueError):
            continue

    def descends(pid: int) -> bool:
        seen = set()
        while pid > 1 and pid not in seen:
            if pid == me:
                return True
            seen.add(pid)
            pid = parents.get(pid, 0)
        return False

    return sorted(pid for pid in parents
                  if pid != me and (pid in marked or descends(pid)))


def stop_strays() -> None:
    """SIGKILL every process the run left (a failed phase's, or one on a
    thread beside it), and say which on standard error."""
    for _ in range(3):  # a thread beside may start one meanwhile
        strays = _strays()
        if not strays:
            return
        for pid in strays:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()
                os.kill(pid, signal.SIGKILL)
            except OSError:
                continue
            print(f"chip_smoke: stopped pid {pid} the run left: "
                  f"{argv[:200]}", file=sys.stderr, flush=True)
        time.sleep(0.5)


def _count(tree) -> int:
    return sum(_count(v) if isinstance(v, dict) else v.size
               for v in tree.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import rafiki_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    marks = [t0]

    def mark(phases: str) -> None:
        """Each phase's share of the run, for the time limit's budget."""
        marks.append(time.perf_counter())
        print(f"chip_smoke: phase {phases} took {marks[-1] - marks[-2]:.1f}"
              f" s ({marks[-1] - t0:.0f} s in)", flush=True)

    card = card_line()
    # phases 7 and 11 launch no attention kernel (their launches are held
    # to 0): they run while nvcc builds, and phase 2 times the kernels
    # once they are done
    beside = _Beside(lambda: (zoo_phase(card),
                              generation_tagging_phase(card)))
    build_kernels()
    mark("1 (the build)")
    zoo_launches, gen_launches = beside.join()
    mark("7 and 11 (beside the build, from its end)")
    entries, kernel_ms = kernel_phase()
    mark("2")
    db, uris, trials, job_s, train_launches = train_phase(card)
    mark("3")
    serve_launches = serve_phase(card, kernel_ms, db, trials)
    mark("4")
    stack_launches, stack_job_s = stack_phase(card, uris, job_s)
    mark("5")
    process_launches = process_phase(card, uris, stack_job_s)
    mark("6")
    bert_launches, lm_launches = text_phase(card)
    mark("8")
    loop_launches = trial_loop_phase(card, uris, resume=False)
    mark("9 (9d beside 18 and 19)")
    cards_launches = cards_phase(card)
    mark("10")
    fused_shape, control_launches = serving_control_phase(card)
    mark("12")
    rest_launches = generation_rest_phase(card)
    mark("13")
    pop_launches, int8_launches = population_int8_phase(card)
    mark("14")
    mp_launches = model_parallel_phase(card)
    mark("15")
    fleet_launches = fleet_phase(card)
    mark("16")
    drift_launches = drift_sandbox_phase(card, uris)
    mark("17")
    # phases 18, 19 and 9d count their launches from their children's exit
    # lines and share nothing (their own stores, ports, rings and logs; 18
    # and 19 pass their processes no RAFIKI_ setting of this one, which
    # 9d's drill sets, and copy the environment once it is set): 19 and 9d
    # run on threads beside 18
    entered = threading.Event()
    resume = _Beside(lambda: timed_resume_drill(card, uris, entered))
    require(entered.wait(120), "9d never started")
    beside = _Beside(lambda: hosts_phase(card, uris))
    ha_launches = ha_phase(card, uris)
    mark("18 (19 and 9d beside it)")
    hosts_launches = beside.join()
    mark("19 (beside 18, from its end)")
    loop_launches = [a + b for a, b in zip(loop_launches, resume.join())]
    mark("9d (beside 18, from 19's end)")
    obs_launches = observability_phase(card, uris, entries)
    mark("20")
    for i, name in enumerate(KERNEL_NAMES):
        by_path = {"train (phase 3)": train_launches[i],
                   "serve (phase 4)": serve_launches[i],
                   "stack (phase 5)": stack_launches[i],
                   "process (phase 6)": process_launches[i],
                   "zoo (phase 7)": zoo_launches[i],
                   "bert (phase 8a)": bert_launches[i],
                   "lm (phase 8b)": lm_launches[i],
                   "trial loop (phase 9)": loop_launches[i],
                   "several cards (phase 10)": cards_launches[i],
                   "generation and tagging (phase 11)": gen_launches[i],
                   "serving control (phase 12)": control_launches[i],
                   "generation, the rest (phase 13)": rest_launches[i],
                   "populations (phase 14a-c)": pop_launches[i],
                   "int8 serving (phase 14d)": int8_launches[i],
                   "model parallel (phase 15)": mp_launches[i],
                   "fleet operations (phase 16)": fleet_launches[i],
                   "drift and sandbox (phase 17)": drift_launches[i],
                   "control-plane HA (phase 18)": ha_launches[i],
                   "hosts and agents (phase 19)": hosts_launches[i],
                   "observability (phase 20)": obs_launches[i]}
        require(by_path["stack (phase 5)"] > 0,
                f"{name} was not launched through the admin")
        require(by_path["process (phase 6)"] > 0,
                f"{name} was not launched in a child process")
        require(by_path["bert (phase 8a)"] > 0,
                f"{name} was not launched on the BERT path")
        require(by_path["lm (phase 8b)"] > 0,
                f"{name} was not launched on the LM path")
        require(by_path["trial loop (phase 9)"] > 0,
                f"{name} was not launched on the trial loop's path")
        require(by_path["several cards (phase 10)"] > 0,
                f"{name} was not launched on the several-card path")
        require(by_path["generation, the rest (phase 13)"] > 0,
                f"{name} was not launched on phase 13's path (the draft)")
        require(by_path["model parallel (phase 15)"] > 0,
                f"{name} was not launched on the model-parallel path")
        require(by_path["drift and sandbox (phase 17)"] > 0,
                f"{name} was not launched on the drift and sandbox path")
        require(by_path["control-plane HA (phase 18)"] > 0,
                f"{name} was not launched on the control-plane HA path")
        require(by_path["hosts and agents (phase 19)"] > 0,
                f"{name} was not launched on the hosts and agents path")
        require(by_path["observability (phase 20)"] > 0,
                f"{name} was not launched on the observability path")
        if name == "flash_fwd":
            require(by_path["serving control (phase 12)"] > 0,
                    "K1 was not launched on the serving-control path")
            require(by_path["int8 serving (phase 14d)"] > 0,
                    "K1 was not launched on the int8 serving path")
            require(by_path["fleet operations (phase 16)"] > 0,
                    "K1 was not launched on the fleet path")
            entries[name]["shapes"] = [fused_shape]
        entries[name]["launches"] = stack_launches[i]
        entries[name]["launches_by_path"] = by_path
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps({"kernels": [entries[name] for name in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    try:
        code = main()
    finally:
        stop_strays()
    sys.exit(code)
