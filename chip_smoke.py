"""Chip check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the exit code is nonzero:

1. build every kernel under mscl_torch/csrc with nvcc (sm_90a), in parallel,
   and every host source there (png_unfilter.c, jpeg_decode.c,
   lz4codec.cpp) with the host C or C++ compiler;
2. hold the decayed-InfoNCE kernels against their plain PyTorch versions and
   float64 at the flagship shapes (B=32, C=128, K=65536, float32) and time
   them in turns with the one PyTorch call that computes the same product
   (kernel, library, library, kernel), then their plain versions, and one
   plain read of the queue as the floor of their bytes; log each kernel's
   device time in one profiled call, their ptxas report and launch shape;
   the same checks and times at the other pretrain configs' batches, B=8
   and 16 (kernel_batch lines);
3. hold the correlation-lookup kernel against its plain version and float64
   at the flow-extraction shape (N=8, 16x22: 128x171 frames padded to
   128x176, at 1/8) and at RAFT's 440x1024 (N=1, 55x128), C=256, L=4, r=4,
   with coords the grid plus normal noise of scale 8, a smooth flow, and (at
   440x1024) noise of scale 64, whose window unions exceed a stage; two
   calls must give the same bits; coords at -1000 must give exact zeros;
   time the kernel (and its host time a call, and level 0 alone) and its
   plain version with L2 flushed; log the corners, the bytes a per-corner
   gather would move and the bytes the kernel's tiles stage; its ptxas
   report and launch (no spill) and a SASS check for its staging copies
   (corr_lookup_ptxas);
4. the tensor-core fill probes (mxu_fill): each kernel against its plain
   version and float64 at the first case of each of the tool's case lists
   (M=3248; carry also at mt=1624), then timed at 132 steps with L2 flushed
   beside its plain version (and, for bigdot, one batched torch.matmul),
   each under the card's 989 TF/s; each probe's persistent kernel also at
   66 steps (its fastest launch at 132 must take 1.7-2.3x as long), with
   its plan (tile, ring, slabs, sub-tiles, blocks, groups), the L2 bytes
   it implies and the host's time for a call; every kernel's SASS checked
   for wgmma and TMA and no mma.sync (probe's and paircat's also for
   shared loads and stores, their accumulator), and ptxas's report for no
   spill (and where it serialized wgmma); then the tool's three case lists
   through its main() at its own steps, and cuDNN's r3d_18 layer1
   convolution as the yardstick;
5. the device augmentation (the flagship config's SyncMoCoAugmentV5) at the
   flagship batch (32 clips of 3x8x112x112, flows 2x16x112x112): on the
   card against the CPU with the same draws, float32; the card generator's
   rates at B=4096; its device time alone (draws and apply) in float32 and
   bfloat16; and one call under torch.cuda.set_sync_debug_mode('error'),
   which fails on any host synchronisation;
6. hold the port on the card against the port on the CPU (kernels and
   cuDNN against the plain versions): two train steps of a narrow
   MSCLWithAug with IdentityAug and with V5 (both fed the same draws), two
   train steps and forward_test of a narrow Recognizer3D (r3d_18 8 wide,
   I3DHead, dropout 0, SGD under the step policy with the clip acting),
   and RAFT (full width, 64x64 images, 3 iterations);
7. drive the flagship config's own MSCLWithAug r18 pretrain step (full
   width, K=65536, SyncMoCoAugmentV5, batch 32) through
   build_model_from_cfg, build_optimizer and make_train_step, in float32
   and then in bfloat16: 3 steps each, then profile one;
8. drive flow extraction through make_raft_fn(None, iters=12) (RAFT large
   at full width, random weights from a seed): 3 batches of 8 synthetic
   frame pairs at 128x171, then profile one;
9. pretrain_cli: the pretrain entry point end to end. A Kinetics-shaped
   rawframe set is written to a temporary directory (64 videos of 250
   frame entries over 16 distinct 256x340 PNGs each, every row's filter
   chosen adaptively as libpng does, flows as 128x171 float32 .npy, an
   MDS-like chosen_idx, a train pickle listing the videos 4 times and a
   val pickle), then ``python -m mscl_torch.tools.train`` runs in this
   process on the flagship config file itself with --validate --seed 0
   and --cfg-options for the pickles, total_epochs=1, a checkpoint,
   validation and a log line every epoch and step, and the work dir
   (workers_per_gpu stays 4): 1 epoch of 8 steps followed by one val
   step; then it resumes from epoch_1 with total_epochs=2. It
   fails unless every logged loss is finite, queue_ptr, iters and the
   launches are those of 16 train steps and 2 val steps (a val step
   launches l_neg 7 times and dq never), epoch_1, epoch_2 and latest
   exist, the state loaded at resume equals the state saved bitwise
   (parameters, buffers, momentum, steps, the aug generator) and the
   resumed run starts at step 8. It
   logs each log line's time and data_time, the steady iterations a second
   and data-wait share (each epoch's steps 3..5, while the producer
   decodes beside them), the cold-start batch wait, the epoch's last 3
   steps (alone), peak memory, checkpoint bytes and the seconds to copy
   the state, save and load it, and the host time to decode one frame
   with the C row unfilter and with numpy's;
10. pretrain_cli_process: the same config and data with
   ``data.workers_mode=process`` (4 decode processes, a whole batch
   each), 1 epoch: the same checks of losses, launches and queues, no
   decode process left after the run, the steady window beside thread
   mode's, and the bytes of one batch's pickle on the result queue and
   the time to unpickle it;
10b. pretrain_dp: data parallelism (``mscl_torch/parallel``) on the one
   card. (a) One global batch of 32 from pretrain_cli's set through the
   config's pipeline; 2 flagship steps (full width, K=65536, V5, float32,
   TF32 off) with no process group, then the same at world 2, two spawned
   gloo ranks sharing the card with 16 rows each: after each step every
   loss key, the queues (count, queue_ptr and iters exact) and the EMA key
   towers within the CPU tests' tolerances of world 1's, the BN
   statistics and the query side after SGD too after the first step; the
   ranks' states equal bitwise. After the second step those two are
   ill-conditioned at full width (world 1 with its images one ulp smaller
   or larger moves them 3-12x the tolerances: the ulp controls,
   no_group_ulp and no_group_ulp_up), so there each path's share of
   their tolerance is held to DP_ULP_MULT times the controls' larger
   share, and both steps are held in full at a narrow width (DP_NARROW)
   at world 2; (c) the full-width steps at world 1 under NCCL, held as in
   (a); (b) the training CLI at world 2 through its launcher
   (``launch.run`` with ``--num-devices 2``: two ranks on the one card
   talk over gloo), 16 rows a rank, over the set's first 128 entries
   (cut from 256, to pay for 14d): 1 epoch of 4 global steps with
   validation, then a resume to a second; one loss on both ranks every
   step, files written by rank 0 only, the state loaded at resume equal
   to the state saved, bitwise, on both ranks, queues and launches as the
   steps imply. It logs each path's step times, the collectives a step (BN
   calls, gradient buckets, key gathers, with their bytes), peak memory and
   launches a rank, and the CLI's steady step;
11. finetune_cli: README workload 2, the fine-tune config
   (configs/recognition/ssl_test/test_ssv2_r18.py: r3d_18 64 wide,
   I3DHead for 174 classes, dropout 0.5, batch 32, 16-frame 112x112
   training clips, 16-frame 128x128 val clips, SGD lr 0.12 under the step
   policy) through ``python -m mscl_torch.tools.train --validate`` over a
   synthetic SSv2-shaped set (64 videos of 24 240x320 PNG frames, 174
   labels, listed 4 times: 8 steps an epoch; 32 val videos), its backbone
   from pretrain_cli's last checkpoint, 2 epochs with the step policy's
   milestone at epoch 1 and validation by metrics after each. It fails
   unless the backbone equals the checkpoint's encoder_q bitwise before
   step 1, each logged lr is the policy's, every val line has top1, top5
   and mean-class accuracy and the checkpoints exist; it logs the steady
   window as pretrain_cli's, peak memory, checkpoint bytes, and one more
   train step profiled;
12. test_cli: ``python -m mscl_torch.tools.test`` on the fine-tuned
   checkpoint over the 32 val videos (8 clips of 128x128): the metrics it
   prints and writes, videos/s over the CLI and over its decode and
   forward loop;
13. retrieval_cli: README workload 3, ``python -m
   mscl_torch.tools.test_retrieval --ssl`` on the pretrain checkpoint's
   encoder, as configured and with the train split set to the test split,
   where recall@1 must be 1; features/s;
14. readme_jpeg: the README's chain from JPEG frames, with neither cv2 nor
   msgpack on the machine: the C JPEG decoder on every committed fixture
   (tests/fixtures_torch/jpeg) at reduce 1 and 2 against the digests of
   cv2's decode, the native LZ4 codec and the C decoder loaded (no
   fallback), one frame's decode ms and the np4 codec's MB/s; then 8
   videos of 250 img_{:05}.jpg entries over the committed frames through
   ``python -m mscl_torch.apis.flow_extraction`` (RAFT from seeded random
   weights, 128x171, gap 2, adjacent 8: 121 flows a video), ``python -m
   mscl_torch.tools.generate_mcl_samples`` (motion_map), the training CLI
   on the flagship config (1 epoch of 8 steps from the JPEGs at the
   decode plan's reduce, the .np4 flows and chosen_idx) and on the
   fine-tune config from its checkpoint (1 epoch of 8 steps). It fails
   unless the digests match, the lookup launches 12 times a RAFT forward
   and decayed InfoNCE 7 + 7 times a train step (none in fine-tuning),
   every chosen_idx is non-empty and inside its flow timeline, MDS read
   the bytes extraction wrote, some frames took the half-scale decode and
   every loss is finite. It logs extraction pairs/s, MDS videos/s and
   each training run's steady window;
14b. flow_tooling: the flow and motion tools through their entry points,
   with neither cv2 nor msgpack: the C JPEG encoder on the committed
   cases against the sha256 of cv2's bytes
   (tests/fixtures_torch/jpeg/encode_digests.json); 8 videos of 40 JPEG
   entries through ``flow_extraction --method arflow`` (PWC-Lite from
   seeded weights at 128x171, padded to 128x192) and ``--method raft``,
   each model built and warmed before its timed run; PWC-Lite on the card
   against the CPU on 4 of its pairs; ``flow2img --with-bboxes`` (twice)
   and ``visualize_samples`` on RAFT's blobs; ``vis_flow`` on one video
   at 256x340 and with ``--resize 171 128``. It fails unless the digests
   match, every blob decodes to a finite 128x171 flow, PWC-Lite's levels
   agree within 1e-3 of their largest entry, ARFlow launches no lookup
   and RAFT 12 a forward (each vis_flow run one forward, its last lookup
   held against the plain version and float64), every flow image decodes
   to its flow's size, gt_bboxes has a box a frame and the sheets and
   bboxes.npy are written. It logs ARFlow's and RAFT's pairs/s over the
   128 pairs and their build seconds, PWC-Lite's device ms a batch of 8
   pairs, vis_flow's RAFT forward over 10 warm calls at each size (host
   clock through the tool's function; device time of the model alone),
   the lookup's launches, a 128x171 flow image's encode ms, flow2img
   videos/s of each run and inference_bboxs ms a video (3 passes over the
   8 videos), and its seconds;
14c. recognition_configs: the I3D, SlowOnly and PoseC3D recipes of configs/,
   each at its own model, batch, clip length and crop, float32: a
   Kinetics-shaped rawframe set written with the port's JPEG encoder (32 videos
   of 72 256x340 frames, and the same as grey x/y flow pairs) and an NTU-shaped
   skeleton pickle (64 samples, 2 persons, 17 COCO keypoints, 100 frames,
   heatmaps at img_shape 56x56: a cut, NTU's 1080x1920 would make 6.8 GB of
   heatmaps a sample); for each of the seven trainable configs (i3d_r50_dense
   and _lazy, slowonly_r50_8x8x1, the ImageNet 8x4x1 recipe, the flow recipe,
   PoseC3D NTU-60 and -120) its narrowed model (base_channels 8, one block a
   stage) on the card in float32 against the CPU in float64 on a batch of its
   own train pipeline (forward_test's logits before any step within 1e-3 of
   their spread from the CPU's float32; one train step: its loss within 1e-3
   of float64's, each parameter's gradient and update, by relative norm, no
   further from float64 than 8 times the CPU's own float32 (the parameter's,
   or the median over the model's where larger), or than 1e-2 where that is
   less; then the loss at the card's updated weights within 1e-3 of the
   CPU's at the same weights;
   ``recognition_card_vs_cpu``; the seven checks first, their CPU runs side
   by side in spawned workers), then the training CLI on the file itself (1
   epoch of 4 steps at its batch, validation where its val pipeline is NCTHW)
   and one more step profiled; the test CLI on i3d_r50_dense's checkpoint (10
   dense clips a video, 4 videos, cut from 8 to pay for 14e); and the
   refusals by name: i3d_r50_32x2x1 and
   slowonly_r50_4x16x1_rgb (NTHWC clips) before their first step, the PoseC3D
   limb config (left_kp) and the video config (VideoDataset). It fails unless
   every loss is finite and no decayed-InfoNCE or lookup kernel launched; it
   logs each config's steady ms a step (steps 3-4), data-wait share, the
   profiled step's device ms and idle share, peak memory, and the test CLI's
   videos/s;
14d. recognition_2d: the frame-based recipes (Recognizer2D: TSN, TSM, TIN,
   TANet, TRN, TSM on MobileNetV2, OmniSource's TSN) and C3D on 14c's sets,
   each config at its own model, batch, segments, crop and in_channels,
   float32: for each of the 16 configs the sweep builds in full, its model at
   full width with dropout 0 on the card against the CPU on one clip of its own
   train pipeline, held as in 14c (tsn_r101_mmit's forward_test only: its
   multi-class target is refused; the CPU's float32 and float64 runs in
   RC_POOL spawned workers while the card runs the next configs; configs
   whose models differ only in their class count and dropout and whose clips
   agree in shape, RC2D_STEP_GROUPS, hold their logits and share one step
   check, after a check that their configs and state dicts agree; the
   step checks of the configs over a 2D ResNet at a smaller depth,
   RC2D_STEP_BLOCKS blocks a stage, their full-depth logits held on the
   card against its float64), and tsm_r50_1x1x8 and tin_r50 again on the
   card with the TSM shift or TIN's shift switched off, planted faults that
   must fail that check; the training CLI on tsn_r50_1x1x3 (with validation),
   tsm_r50_1x1x8 and tin_r50 (1 epoch: 4, 4 and 5 steps at their batches of 8,
   8 and 6) and one more step profiled; the test CLI on the TSN checkpoint (9
   views a video, 4 videos), its metrics in [0, 1]; and the refusals by name:
   C3D (NTHWC clips) before its first step, the tsn and tsm video configs
   (VideoDataset), the OmniSource config (its list
   of train sets) and tsn_r101_mmit (its multi-class target). It fails unless
   every loss is finite and no kernel of the port launched; it logs each
   trained config's steady ms, data-wait share, profiled device ms and idle
   share and peak memory in a headline record;
14e. recognition_3d_zoo: the 3D recognition zoo and the TPN neck on 14c's
   sets: card against CPU (as 14d, the CPU's runs in a pool) for the 11
   configs the sweep builds in full (SlowFast r50 4x16 and 8x8 and r101,
   R(2+1)D r18 and r34, X3D-M, ir-CSN r152, S3D, TimeSformer divST, TPN over
   SlowOnly and over TSM), each its own model at full width and depth with
   dropout 0 in the head (TPN's fixed aux dropout drawn from one CPU stream
   on both devices), clips formatted NCTHW; the logits at the config's own
   clip, the step check on a clip cut in frames and crop (ZOO_CONFIGS'
   cuts: the CPU's float64 step on the own clip takes 9-85 s,
   zoo_step_costs; widths, depth and SlowFast's ratios stay; TimeSformer's
   step model takes the cut clip's size; X3D-M on two clips, ZOO_CLIPS),
   and
   SlowFast with its lateral convs' outputs zeroed and TimeSformer with its
   temporal attention made the identity, planted faults that must fail it;
   the training CLI on tpn_tsm_r50 as shipped (loss_aux logged and finite)
   and on slowfast_r50_4x16x1 from a config derived from the shipped file
   with every FormatShape NCTHW (with validation; then the test CLI on its
   checkpoint, metrics in [0, 1]); the refusals by name: the other NTHWC
   configs and SlowFast's as shipped before their first step (at one clip
   a batch, as every phase's NTHWC refusals), x3d_s at its
   data (a codec). No kernel of the port launches; a headline record as
   14d's;
15. pretrain_configs: every config of configs/recognition/moco (MSCL r18,
   the flagship, as a control; MSCL r50; MoCo r18 with MoCoAugmentV2, with
   SyncMoCoAugmentV2 at 'params' and at 'batch'; MoCo r50): its own model
   from the file at full width, float32, K=65536, 3 train steps on a
   synthetic batch of its shapes (its batch of 32, 16 or 8, 112 or 224
   crops, 8 frames, the flows for MSCL, its aug), then one profiled; it
   fails unless every loss is finite, the queues and iters advance as the
   model implies and the decayed-InfoNCE launches are 7 + 7 (MSCL) or 1 + 1
   (MoCo) a step. Then card against CPU (as 6) for MoCo with each of its
   three augs and for MSCL with r50 towers, narrowed; then the training CLI
   in thread mode over pretrain_cli's set on mscl_r50 (1 epoch of 8 steps
   and a resume for a second, whose loaded state must equal the saved one
   and whose first step's logged values must equal, bitwise, those the
   saving run's model gives on the same batch) and on moco_r18_lr3e-2 (1
   epoch of 8 steps), with launches, queues and the steady window as in 9;
16. ablation_arms: the MSCL ablation family (the Round-5 ablation tool,
   mscl_torch/tools/ablation_ordering.py). The decayed-InfoNCE pair at the
   tool's shapes, B=32, C=128, K=2048 (full scale) and B=16, C=32, K=256
   (tiny), against its plain version and float64 and timed beside
   torch.matmul (kernel_ablation lines); card against CPU (as 6) for each
   of the five arms at the tool's tiny scale on its own batches, for the
   full arm with ShuffleBN (4 groups), with its flow passes as one forward
   and under two flow keys, and for the narrow flagship whose RGB neck has
   TemporalModulation, reverse_st and SEPC's iBN; then the tool's main()
   at --scale full, 5 steps, for each arm (moco, modist, mscl_nofra, mscl,
   mscl_nomds): it fails unless each kernel launches 1, 4, 4, 7, 7 times a
   step, every loss is finite and the JSON has the JAX tool's keys; it
   logs each arm's steady ms a step (steps 2, 3 and 5), the idle share of
   step 4 profiled, peak memory and the downstream metrics (ablation_arm
   lines); then shufflebn_ab through its main() (10 steps a run) and
   ShuffleBN at world 2 (two gloo ranks sharing the card, the narrow
   flagship model, a global batch of 8) against no group within the
   pretrain_dp tolerances (shufflebn_ab line);
17. mscl_family: the rest of the MSCL family. (a) The flagship config
   with ``--cfg-options model.moco_mx_head.type=MSCLWithAugMSFMxHead`` (and
   that head's own multi-positive loss) through the training CLI at full
   width (float32, K=65536, V5, batch 32) over pretrain_cli's videos: 1
   epoch of MF_STEPS steps, thread workers, no validation; it fails unless
   every logged loss is finite (the four MSF terms among them), each
   tower's queue_ptr, iters and count are those of MF_STEPS enqueues and
   the decayed-InfoNCE kernels launched 11 + 7 times a step (the towers'
   3 + 3; 2 + 1 per _msf_sp_sn, 2 directions x 2 flow passes); it logs
   each step's ms (the last one runs after the producer has made the
   epoch's last batch: the step alone) and the idle share of one more step
   profiled. (b) Card against CPU within STEP_TOL: every head
   of heads/moco_head_v3.py (the distill head with and without small_p) at
   B=32, C=128, K=4096, the circle losses and TripletLoss, every head of
   heads/reid_distill_heads.py (outputs, losses, gradients, the BN-neck's
   statistics), and two train steps (as 6) of the narrow MSCLWithAug with
   the MSF head and of a MoCo tower on ResNet3dSlowOnly_TwoR5 through
   BaseMoCo_TwoR5. (c) ``python -m mscl_torch.tools.clip_feature_extraction``
   on finetune_cli's checkpoint over its test videos (finite (32, 512)
   features, the videos' labels, no decayed-InfoNCE launch) and ``python -m
   mscl_torch.tools.merge_pkls`` on two shards of an annotation list the
   phase writes (each video once, as in the unsharded list);
18. localization: temporal action localization at the shipped configs'
   full widths on synthetic data from a seed (an ActivityNet-style set of
   20 videos of 400 features, a THUMOS-style set of 4 videos of 96 JPEG
   frames with its SSN proposal list). BMN (T 100, 32 x 3 samples,
   hidden 256/128/512, batch 8, the config's Adam): the sample mask's
   host build timed, 3 steps on labels from its generate_labels (the
   port's train_model refuses BMN, TEM and PEM by name: JAX's cannot
   train them as shipped), one more profiled, the boundary-matching
   product timed against its bound, then forward_test and the host
   proposals of 4 val videos into ActivityNetDataset.evaluate (AR@1, 5,
   10, 100, AUC). BSN: TEM (400 -> 512, batch 16) 3 steps, its curves for
   every video written as the TEM csv files, the ported
   bsn_proposal_generation on them, PEM (32 -> 256) 3 steps on a batch's
   proposals (top_k 500) and AR@AN over its test pipeline's (top_k 1000).
   SSN's shipped config through train_model (ResNet-50 at 224, 8
   proposals x 9 segments a video, SGD with clip 40: 4 steps), one more
   step profiled, a test pass over every proposal into evaluate's mAP,
   then the ported report_map on its detections. Card against CPU: BMN,
   TEM, PEM and the trained SSN forward (eval mode) within LOC_SHARE of
   the CPU's spread, BMN's losses with the same uniforms within
   RC_LOSS_TOL. The HVU config (tsn_r18_1x1x8_100e_hvu_action_rgb) through
   the training CLI on a synthetic HVU set stops by name before a step,
   where JAX's data path fails: at its None filename_tmpl, and with one
   set at LoadHVULabel on the one-hot target; its model refuses that
   target on the card (multi_class). It fails unless every loss and
   metric is finite and in range and no kernel of the port launched; a
   headline record gives each model's steady ms, idle share and peak
   memory;
19. audio: the audio recipes at the configs' full widths. 64 wavs of 10 s
   at 16 kHz (int16) are written and turned into 640x80 log-mel features
   by the ported ``build_audio_features`` (4 forked workers); the feature
   config (ResNetAudio-50, base 32, 128x80 clips, SGD with clip 40) runs
   through the training CLI for 4 steps at batch 32 with validation, then
   the test CLI on its checkpoint (10 clips a video) and evaluate; the raw
   audio config (a 2D ResNet-50 over one-channel log-mels of 2 s crops)
   for 4 steps; both models card against CPU (logits within 1e-3 of
   their spread). A headline record gives each model's steady ms, data
   wait, a profiled step's device ms and idle share, and peak memory;
20. detection: AVA spatio-temporal detection at the shipped configs' full
   widths on an AVA-shaped set written from a seed (a csv of 8 videos x
   5 keyframes, a proposal pickle with scores, an exclude file, JPEG
   rawframes at 320x240): card against CPU for the 8 distinct models
   (SlowOnly-50, -101, -NL; SlowFast 4x16 with and without
   ``with_global``; SlowFast 8x8 with temporal max and the focal loss;
   LFB non-local; ACRN) on one clip of 8 RoIs (the scores in eval mode
   within 1e-3 of their spread, the train-mode loss within 1e-3 and the
   bbox head's gradient within 1e-2, dropout 0; the CPU's runs in the
   reference workers), then one step on the card under the config's SGD;
   the other 8 configs built and run forward; the SlowOnly-50 config
   through the training CLI (batch 8, 4x16 frames, 256 crops, 32 RoIs a
   clip, 4 steps); forward_test on the keyframes into
   ``AVADataset.evaluate`` (mAP@0.5IOU); the LFB end to end
   (``LFBInferHead`` writes lfb_train.pkl, ``LFB`` samples a 300 x 2048
   block a RoI, the lfb_nl model's forward_test takes it). Neither
   phase launches a kernel of the port;
21. print the card's name and power limit, the kernel table and the
   result. Each phase's seconds are logged (phase_seconds).

Every phase's log lines (and the CLIs' and spawned ranks' own output) go
to build/chip_smoke.log; the script's stdout has one summary line a phase
(its headline numbers; a phase that fails raises, and the end of the log
is printed), then the card's name and power limit, the kernel table and
the result, well inside the 24 KB a caller may keep of it.

Every kernel launch counter is set to 0 just before each of the paths 7
(each dtype), 8, 9 (each of its two runs), 10, 10b (in each rank, before
its steps and before each CLI run), 15 (each config's steps and each CLI
run), 14b (each extraction run and each vis_flow run), 14c and 14d (each
CLI run: none may launch a kernel), 11-14 (each CLI run; the fine-tune,
test and retrieval paths must launch no decayed-InfoNCE kernel: r3d_18 goes
to cuDNN), the probe tool's run in 4 and 16 (each arm's run of the tool,
the A/B's two runs), 17 (the CLI run), 18-20 (their paths: none may
launch a kernel), and read just after. The kernel table's decayed-InfoNCE
launches are the pretrain CLI's (both runs of 9).
It needs a CUDA device: without one it exits nonzero before printing any
result.
"""
from __future__ import annotations

import builtins
import contextlib
import copy
import hashlib
import importlib
import json
import math
import os
import os.path as osp
import pickle
import random
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from mscl_torch.apis import (FLAGSHIP_AUG, MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, load_flagship_config,
                             narrow_flagship_cfg, to_torch)
from mscl_torch.apis import flow_extraction as extraction_cli
from mscl_torch.apis.flow_extraction import make_raft_fn
from mscl_torch.config import Config
from mscl_torch.apis import FLAGSHIP_CONFIG
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    load_checkpoint, make_train_step, train_loop
from mscl_torch.flow import build_raft
from mscl_torch.models import build_ssl_aug
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.ops import corr_lookup as cl
from mscl_torch.ops import cuda_build
from mscl_torch.ops import decayed_infonce as di
from mscl_torch.ops import mxu_fill as mf
from mscl_torch.parallel import dist, launch
from mscl_torch.tools import bench_mxu_fill as bm
from mscl_torch.tools import test as test_cli
from mscl_torch.tools import test_retrieval as retrieval_cli
from mscl_torch.tools import train as train_cli
from mscl_torch.tools import generate_mcl_samples as mds_cli
from mscl_torch.tools import ablation_ordering as abl_tool
from mscl_torch.tools import shufflebn_ab as sbn_tool
from mscl_torch.tools import flow2img as flow2img_cli
from mscl_torch.tools import vis_flow as vis_flow_cli
from mscl_torch.tools import visualize_samples as samples_cli
from mscl_torch.flow import flow_bbox
from mscl_torch.utils import flow_viz, image_io, jpeg, np4

B, C, K = 32, 128, 65536
# the decayed-InfoNCE batches of the other pretrain configs: 8 (mscl_r50,
# moco_r50), 16 (moco_r18)
KERNEL_BATCHES = (8, 16)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_ops.py forward
DQ_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_ops.py gradient
# each kernel against float64, relative to its output's largest entry: f32
# rounding at the flagship shapes is about 1e-6 of it, one dropped K-tile
# of the 65536 about 1e-2
F64_REL = 1e-5
# card vs CPU on the narrow model: cuDNN and the kernels sum in other orders
# than the CPU, and the 1/T = 14.3 logit scale amplifies f32 rounding
STEP_TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_KEYS = ['loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug', 'loss_cls_mx',
             'loss_cls_mx_r', 'loss_cls_mx_aug', 'loss_cls_mx_r_aug',
             'loss_pos']
# the loss terms a train step must log, by recognizer
STEP_LOSSES = {'MSCLWithAug': LOSS_KEYS + ['loss'],
               'MSCL': ['loss_cls', 'loss_cls_flow', 'loss_cls_mx',
                        'loss_cls_mx_r', 'loss_pos', 'loss'],
               'MoDist': ['loss_cls', 'loss_cls_flow', 'loss_cls_mx',
                          'loss_cls_mx_r', 'loss'],
               'MoCo': ['loss_cls', 'loss'], 'MoCoV2': ['loss_cls', 'loss']}
STEPS = 3
# correlation lookup: (shape name, N, H, W) at C=256, 4 levels, radius 4
CORR_SHAPES = (('extraction_16x22', 8, 16, 22), ('raft_55x128', 1, 55, 128))
CORR_C, CORR_LEVELS, CORR_RADIUS = 256, 4, 4
CORR_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_ops.py atol; C=256 sums
# wide flow at RAFT's 440x1024: window unions beyond one stage
CORR_WIDE_SHAPE, CORR_WIDE_SCALE = 'raft_55x128', 64.0
# RAFT card vs CPU: the CPU's float32 flows differ from float64 ones by
# about 7e-6 at a largest flow of 10 (64x64, 3 iterations); cuDNN sums in
# other orders (and may take Winograd), so 100 times that
RAFT_TOL = dict(rtol=1e-3, atol=1e-3)
EXTRACT_PAIRS, EXTRACT_HW, EXTRACT_BATCHES, RAFT_ITERS = 8, (128, 171), 3, 12
# fill probes at 132 steps: each kernel walks its (step, tile) units on
# persistent blocks (probe, bigdot, imcat 1,716 of 256 rows, carry at
# mt=112 3,828 of 128); the tool's first case of each probe
MXU_STEPS = 132
MXU_TOL = dict(rtol=1e-2, atol=1e-2)   # one bf16 rounding, sums reordered
MXU_F64_REL = 8e-3                     # one bf16 rounding (2^-7) of the max
MXU_CLI_ITERS = 3                      # the tool's default
MXU_ROWS = (('mxu_fill_probe', '', 0), ('mxu_fill_carry', 'carry', 0),
            ('mxu_fill_bigdot', 'kchain', 2), ('mxu_fill_imcat', 'kchain', 4),
            ('mxu_fill_paircat', 'kchain', 6))
MXU_REPLACES = {'probe': 34, 'carry': 72, 'bigdot': 117, 'imcat': 151,
                'paircat': 195}
# the probes' persistent kernels: each step's units must really run, so
# twice the steps take about twice the time
STEPS_RATIO = (1.7, 2.3)
# r3d_18 layer1: (32, 64, 8, 56, 56) -> 64, 3x3x3, padding 1
CONV_SHAPE, CONV_FLOP = (32, 64, 8, 56, 56), 2 * 32 * 8 * 56 * 56 * 64 * 1728
SPIN_CYCLES = 200_000              # about 0.1 ms of the card's clock
# the device aug against the CPU (tests/test_torch_ssl_aug.py): float32
# colour math within 1e-5; the colour wheel's floor(255 col) may flip by
# 1/255 on a share of at most 1e-5 of the elements
AUG_TOL, WHEEL_STEP, WHEEL_SHARE = 1e-5, 1 / 255 + 1e-6, 1e-5
RATE_B = 4096                      # draws for the apply-rate check
AUG_RATES = dict(flip=0.5, jitter=0.8, gray=0.2, blur=0.5)
# pretrain_cli: a Kinetics-shaped rawframe set (frames 256x340 PNG, flows
# 128x171 float32 .npy, the README's extraction size); 64 videos, listed
# 4 times in the train pickle, make 8 steps an epoch at the config's batch
# of 32, so each epoch has a steady window (steps 3..5); the first 32
# videos are the val set
CLI_VIDEOS, CLI_VAL_VIDEOS, CLI_LIST, CLI_REPEAT = 64, 32, 250, 4
CLI_TAIL = 3                       # an epoch's steps after its last batch
CLI_FRAME_FILES, CLI_FLOW_FILES = 16, 8
CLI_FRAME_HW, CLI_FLOW_HW = (256, 340), (128, 171)
# finetune_cli, test_cli, retrieval_cli: the README's fine-tune config over
# an SSv2-shaped rawframe set (240x320 PNG frames, SSv2's short side, 174
# labels); FT_VIDEOS videos listed FT_REPEAT times in the train pickle (8
# steps an epoch at the config's batch of 32, a steady window of steps
# 3..5 as pretrain_cli's), the first FT_VAL_VIDEOS the val and test set
# (one batch)
FT_CONFIG = 'configs/recognition/ssl_test/test_ssv2_r18.py'
FT_VIDEOS, FT_VAL_VIDEOS, FT_REPEAT, FT_FRAMES = 64, 32, 4, 24
FT_FRAME_HW, FT_CLASSES = (240, 320), 174
FT_FEATURES = 512                  # r3d_18's last stage, 64 wide
# readme_jpeg: the README's chain from JPEG frames on the card's machine
# (no cv2, no msgpack there): RJ_VIDEOS videos of CLI_LIST img_{:05}.jpg
# entries cycling over the committed 256x340 frames, extraction at the
# README's 128x171 (gap 2, adjacent 8: 121 flows a video), MDS, then the
# flagship config and the fine-tune config each for 1 epoch of RJ_STEPS
# steps at their batch of 32 (the videos listed RJ_REPEAT times), so each
# has pretrain_cli's steady window (steps 3..5)
JPEG_FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), 'tests',
                         'fixtures_torch', 'jpeg')
RJ_VIDEOS, RJ_REPEAT, RJ_STEPS = 8, 32, 8
RJ_DECODE_ITERS = 50
# flow_tooling: FT_TOOL_VIDEOS videos (readme_jpeg's) of FT_TOOL_ENTRIES
# JPEG entries over the committed frames; ARFlow and RAFT extraction at
# the README's 128x171 (gap 2, adjacent 8: 16 flows a video, 128 pairs),
# flow2img (FT_FLOW2IMG_RUNS runs) and visualize_samples on RAFT's blobs,
# vis_flow on one video (gap 8, adjacent 8: 4 pairs, one RAFT forward) at
# the frames' 256x340 and resized to 171x128, its forward then timed over
# FT_TIMED_ITERS warm calls; inference_bboxs over FT_BBOX_PASSES passes of
# the videos. PWC-Lite on the card against the CPU: each level within
# ARFLOW_REL of its largest entry (cuDNN's float32 sums in other orders,
# TF32 off)
FT_TOOL_VIDEOS, FT_TOOL_ENTRIES, ARFLOW_CHECK_PAIRS = RJ_VIDEOS, 40, 4
FT_TIMED_ITERS, FT_FLOW2IMG_RUNS, FT_BBOX_PASSES = 10, 2, 3
ARFLOW_REL = 1e-3
ENCODE_ITERS = 50
# pretrain_dp: the flagship step on one global batch of DP_BATCH at world 2
# (two gloo ranks sharing the card) and at world 1 under NCCL, against
# world 1 with no process group, DP_STEPS steps; then the pretrain CLI at
# world 2 with DP_CLI_ROWS rows a rank (a global batch of 32). The
# tolerances are the port's CPU tests' (tests/test_mscl_torch_composite.py
# :387,451): (rtol, atol), ints exact. At full width the BN statistics
# and the query side after the second SGD step are ill-conditioned: one
# ulp on the input images moves them 3-12x these tolerances (PERF.md §6,
# the no_group_ulp lines), so there each path's share of the tolerance is
# held to DP_ULP_MULT times the larger share of the two ulp controls; they
# are held in full after the first step and at the narrow width
# (DP_NARROW) for both steps
DP_BATCH, DP_STEPS, DP_CLI_ROWS, DP_ULP_MULT = 32, 2, 16, 2.0
# the CLI at world 2 over the first DP_CLI_STEPS global batches of the
# pretrain set (cut from 8, to pay for recognition_2d), 1 epoch and a
# resume to a second; its steady window each epoch's step 3
DP_CLI_STEPS, DP_CLI_TAIL = 4, 1
DP_TOL = dict(losses=(2e-4, 2e-4), params=(5e-3, 1e-4), queues=(0, 2e-5),
              ema=(1e-5, 1e-6), bn_stats=(1e-4, 1e-5))
DP_ILL_CONDITIONED = ('bn_stats', 'params')
DP_NARROW = dict(K=4096, dim=128, rgb_width=8, flow_width=2)
# pretrain_configs: every config of configs/recognition/moco (the flagship
# as a control), PC_STEPS full-width steps each; the CLI runs PC_CLI_STEPS
# steps an epoch at each config's batch
PRETRAIN_CONFIGS = ('mscl_r18_cosm_lr2e-2', 'mscl_r50_cosm_lr3e-2',
                    'moco_r18_lr3e-2',
                    'moco_r18_consistent_augmentation_lr3e-2',
                    'moco_r18_cosistent_video_lr3e-2',
                    'moco_r50_consistent_augmentation_lr3e-2')
PC_STEPS, PC_CLI_STEPS = 3, 8
# ablation_arms: the decayed-InfoNCE pair at the ablation tool's shapes
# (B, C, K: full scale, tiny scale), the tool's arms and the launches of
# each kernel a train step (2 towers or 1, and 2 or 4 in the Mx head)
ABL_KERNEL_SHAPES = ((32, 128, 2048), (16, 32, 256))
ABL_LAUNCHES = dict(moco=1, modist=4, mscl_nofra=4, mscl=7, mscl_nomds=7)
ABL_STEPS, ABL_PROFILED = 4, 3      # the tool's steps; the one profiled
ABL_AB_STEPS = 10                   # shufflebn_ab's steps a run
# mscl_family: the flagship config with the MSF cross-modal head through
# the training CLI (MF_STEPS steps over pretrain_cli's set, no validation),
# its decayed-InfoNCE products a step (the towers' 3 with their dq; per
# _msf_sp_sn the key's product alone and the query's with its dq, 2
# directions x 2 flow passes), the heads card against CPU at B, C and
# MF_HEAD_K, and the two tools
MF_STEPS, MF_HEAD_K = 4, 4096
MF_LAUNCHES = dict(l_neg=3 + 2 * 2 * 2, dq=3 + 1 * 2 * 2)
MF_OPTIONS = ('model.moco_mx_head.type=MSCLWithAugMSFMxHead',
              # the config's CrossEntropyLoss_torch (with ignore_index) is
              # the InfoNCE head's; the MSF head takes its own default
              'model.moco_mx_head.loss_cls._delete_=True',
              'model.moco_mx_head.loss_cls.type=MultiPositiveSumLoss')
MF_LOSSES = ('loss_circle_mx', 'loss_circle_mx_r', 'loss_circle_mx_aug',
             'loss_circle_mx_r_aug')
# recognition_configs: a Kinetics-shaped rawframe set (RC_VIDEOS videos of
# RC_FRAMES 256x340 JPEG frames, and the same as grey flow pairs; the
# first RC_VAL the val and test set, cut from 8 to pay for
# recognition_3d_zoo) and an NTU-shaped skeleton set
# (RC_POSE samples of RC_POSE_FRAMES frames; heatmaps at RC_POSE_HW, a cut:
# NTU's 1080x1920 would make 17 x 48 x 1080 x 1920 x 4 B = 6.8 GB of
# heatmaps a sample); RC_STEPS steps of each trainable config at its own
# batch (8, PoseC3D 16); card against CPU on RC_CHECK clips
RC_VIDEOS, RC_FRAMES, RC_HW, RC_VAL = 32, 72, (256, 340), 4
RC_POSE, RC_POSE_FRAMES, RC_POSE_HW = 64, 100, (56, 56)
RC_RGB_TMPL = 'img_{:05}.jpg'       # the set's RGB frames
RC_STEPS, RC_CHECK = 4, 2
# card against CPU (recognition_card_vs_cpu): the card's float32 run
# against the CPU's float32 and float64 runs. forward_test's logits before
# any step within RC_LOGIT_TOL of their spread from the CPU's;
# RC_CHECK_STEPS = 2: a train step, its loss within RC_LOSS_TOL of
# float64's, each parameter's gradient and update (the norm of the
# difference over the norm) no further from float64 than RC_F32_MULT
# times the CPU's float32 (the tests' ULP_MULT), or than RC_GRAD_TOL where
# that is less; then the loss at the card's updated weights within
# RC_LOSS_TOL of the CPU's at the same weights
RC_CHECK_STEPS, RC_LOGIT_TOL, RC_LOSS_TOL, RC_GRAD_TOL, RC_F32_MULT = \
    2, 1e-3, 1e-3, 1e-2, 8.0
RECOGNITION_CONFIGS = (   # (label, config, set, validate: val is NCTHW)
    ('i3d_dense', 'configs/recognition/i3d/'
     'i3d_r50_dense_32x2x1_100e_kinetics400_rgb.py', 'rgb', True),
    ('i3d_lazy', 'configs/recognition/i3d/'
     'i3d_r50_lazy_32x2x1_100e_kinetics400_rgb.py', 'rgb', False),
    ('slowonly_8x8', 'configs/recognition/slowonly/'
     'slowonly_r50_8x8x1_256e_kinetics400_rgb.py', 'rgb', True),
    ('slowonly_in_8x4', 'configs/recognition/slowonly/'
     'slowonly_imagenet_pretrained_r50_8x4x1_64e_kinetics400_rgb.py', 'rgb',
     True),
    ('slowonly_flow', 'configs/recognition/slowonly/'
     'slowonly_r50_4x16x1_256e_kinetics400_flow.py', 'flow', False),
    ('posec3d_ntu60', 'configs/skeleton/posec3d/'
     'slowonly_r50_u48_240e_ntu60_xsub_keypoint.py', 'pose', True),
    ('posec3d_ntu120', 'configs/skeleton/posec3d/'
     'slowonly_r50_u48_240e_ntu120_xsub_keypoint.py', 'pose', True))
RC_NTHWC = ('configs/recognition/i3d/i3d_r50_32x2x1_100e_kinetics400_rgb.py',
            'configs/recognition/slowonly/'
            'slowonly_r50_4x16x1_256e_kinetics400_rgb.py')
RC_REFUSED = (('configs/skeleton/posec3d/'
               'slowonly_r50_u48_240e_ntu60_xsub_limb.py', 'left_kp', 'pose'),
              ('configs/recognition/i3d/'
               'i3d_r50_video_32x2x1_100e_kinetics400_rgb.py', 'VideoDataset',
               'rgb'))
# recognition_2d: the frame-based recipes and C3D on recognition_configs'
# sets. Card against CPU for each config the sweep builds in full
# (tests/test_torch_configs.py), its own model at full width with dropout
# 0 (the card's masks are not the CPU's; TRN's subsets drawn alike on
# both), held as recognition_configs holds its models on RC2D_CHECK clips
# of its own train pipeline (C3D's formatted NCTHW, as the port's
# Recognizer3D reads clips); the training CLI on RC2D_TRAIN (RC_STEPS steps
# at each config's batch); the test CLI on the first's checkpoint; the
# refusals by name
# (the first step of a config refused by the model; the rest before it)
RC2D = 'configs/recognition/'
RC2D_CHECK = 1
RC2D_CONFIGS = (   # (label, config, set), the CPU's heaviest checks first
    ('tsm_r50_1x1x16', 'tsm/tsm_r50_1x1x16_50e_kinetics400_rgb.py', 'rgb'),
    ('tsn_r50_1x1x8', 'tsn/tsn_r50_1x1x8_100e_kinetics400_rgb.py', 'rgb'),
    ('tsn_r50_1x1x3', 'tsn/tsn_r50_1x1x3_100e_kinetics400_rgb.py', 'rgb'),
    ('tsn_r50_1x1x3_flow', 'tsn/tsn_r50_1x1x3_110e_kinetics400_flow.py',
     'flow'),
    ('tsm_r50_1x1x8', 'tsm/tsm_r50_1x1x8_50e_kinetics400_rgb.py', 'rgb'),
    ('tin_r50', 'tin/tin_r50_1x1x8_40e_sthv1_rgb.py', 'rgb'),
    ('tanet_r50', 'tanet/tanet_r50_1x1x8_100e_kinetics400_rgb.py', 'rgb'),
    ('trn_r50', 'trn/trn_r50_1x1x8_50e_sthv1_rgb.py', 'rgb'),
    ('c3d', 'c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py', 'rgb'),
    ('tsm_mobilenetv2', 'mobilenet_v2/tsm_mobilenetv2_1x1x8_50e_'
     'kinetics400_rgb.py', 'rgb'),
    ('tsn_r50_ucf101', 'tsn/tsn_r50_1x1x3_75e_ucf101_rgb.py', 'rgb'),
    ('tsn_r50_sthv1', 'tsn/tsn_r50_1x1x8_50e_sthv1_rgb.py', 'rgb'),
    ('tsn_r101_mmit', 'tsn/tsn_r101_1x1x5_50e_mmit_rgb.py', 'rgb'),
    ('tsm_r50_sthv2', 'tsm/tsm_r50_1x1x8_50e_sthv2_rgb.py', 'rgb'),
    ('tsm_r50_dense', 'tsm/tsm_r50_dense_1x1x8_100e_kinetics400_rgb.py',
     'rgb'),
    ('omnisource_tsn_r50', 'omnisource/tsn_r50_1x1x8_100e_minikinetics_'
     'rgb.py', 'rgb'))
# the planted-fault controls: a config again on the card with its shift
# switched off (module, function made the identity on its input); its
# card-vs-CPU check must fail
RC2D_FAULTS = {'tsm_r50_1x1x8': ('resnet2d', 'temporal_shift'),
               'tin_r50': ('resnet_tin', 'tin_shift')}
# configs whose models differ only in cls_head.num_classes and dropout
# (and test_cfg) and whose train clips agree in shape share one step check,
# the first one's (rc2d_step_groups checks that); the others' logits are
# held as every config's are
RC2D_STEP_GROUPS = (('tsn_r50_1x1x3', 'tsn_r50_ucf101', 'tsn_r50_sthv1'),
                    ('tsn_r50_1x1x8', 'omnisource_tsn_r50'),
                    ('tsm_r50_1x1x8', 'tsm_r50_sthv2', 'tsm_r50_dense'))
# the step checks of the configs over a 2D ResNet (RC2D_DEPTH_CUT: TSN,
# TSM, TIN, TANet, TRN) at a smaller depth, each stage cut to its first
# RC2D_STEP_BLOCKS blocks (the one with the stride and downsample, and one
# more): ResNet-50's 16 blocks cut to 8, 57 % of its FLOPs at 224x224; the
# CPU's references, most of the phase, shrink with them. The full-depth
# model's logits are held on the card against its own float64 (depth_cut)
RC2D_STEP_BLOCKS = 2
RC2D_DEPTH_CUT = ('ResNet', 'ResNetTSM', 'ResNetTIN', 'TANet')
# the CPU's float32 and float64 runs of card_vs_cpu in RC_POOL spawned
# workers of RC_POOL_THREADS threads (reference_pool)
RC_POOL, RC_POOL_THREADS = 4, 2
RC2D_TRAIN = (   # (label, validate)
    ('tsn_r50_1x1x3', True), ('tsm_r50_1x1x8', False), ('tin_r50', False))
RC2D_NTHWC = (RC2D + 'c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py',)
RC2D_REFUSED = (
    (RC2D + 'tsn/tsn_r50_video_1x1x8_100e_kinetics400_rgb.py',
     'VideoDataset', 'rgb'),
    (RC2D + 'tsm/tsm_r50_video_1x1x8_50e_kinetics400_rgb.py', 'VideoDataset',
     'rgb'),
    (RC2D + 'omnisource/tsn_r50_1x1x8_100e_minikinetics_rgb.py',
     'OmniSource', None),
    (RC2D + 'tsn/tsn_r101_1x1x5_50e_mmit_rgb.py', 'multi_class', 'rgb'))
# recognition_3d_zoo: (label, config under configs/recognition/, the step
# check's clip cut as (frames, crop) or None; a cut keeps SlowFast's
# resample_rate and speed_ratio dividing the frames)
ZOO = 'configs/recognition/'
ZOO_CONFIGS = (   # the CPU's heaviest checks first
    ('slowfast_r101_8x8x1', 'slowfast/slowfast_r101_8x8x1_256e_kinetics400_'
     'rgb.py', (8, 128)),
    ('timesformer_divST', 'timesformer/timesformer_divST_8x32x1_15e_'
     'kinetics400_rgb.py', (4, 96)),
    ('r2plus1d_r18', 'r2plus1d/r2plus1d_r18_8x8x1_180e_kinetics400_rgb.py',
     (8, 112)),
    ('slowfast_r50_8x8x1', 'slowfast/slowfast_r50_8x8x1_256e_kinetics400_'
     'rgb.py', (16, 128)),
    ('slowfast_r50_4x16x1', 'slowfast/slowfast_r50_4x16x1_256e_kinetics400_'
     'rgb.py', (16, 128)),
    ('ircsn_r152', 'csn/ircsn_r152_32x2x1_180e_kinetics400_rgb.py',
     (8, 128)),
    ('r2plus1d_r34', 'r2plus1d/r2plus1d_r34_8x8x1_180e_kinetics400_rgb.py',
     (8, 96)),
    ('tpn_slowonly_r50', 'tpn/tpn_slowonly_r50_8x8x1_150e_kinetics400_rgb.py',
     (8, 128)),
    ('tpn_tsm_r50', 'tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py', (8, 128)),
    ('s3d', 's3d/s3d_64x1x1_100e_kinetics400_rgb.py', (32, 128)),
    ('x3d_m', 'x3d/x3d_m_16x5x1_facebook_kinetics400_rgb.py', (16, 160)))
# the planted faults: a config again on the card with (module, class,
# method) patched to break it; its card-vs-CPU check must fail
ZOO_FAULTS = {
    'slowfast_r50_4x16x1': ('resnet3d', 'ResNet3dSlowFast', '_laterals'),
    'timesformer_divST': ('timesformer', 'DividedBlock', '_temporal')}
# zoo_step_costs: a step check is cut where the CPU's float64 step on the
# config's own clip takes over ZOO_STEP_S seconds; ZOO_WITNESS, the check
# nearest its bound on one clip, gets a second witness (the card's float64)
ZOO_STEP_S = 8.0
ZOO_WITNESS = ('x3d_m', 'backbone.layer2.0.bn2.bias')
# configs checked on more than RC2D_CHECK clips: X3D's SE squeezes a
# train-mode BN's output, whose mean over one clip is the BN's bias
# exactly, so on one clip its ReLU gates (and the SE and BN gradients)
# are decided by rounding, on the card and on the CPU alike
ZOO_CLIPS = {'x3d_m': 2}
ZOO_PATHS = {label: ZOO + path for label, path, _ in ZOO_CONFIGS}
ZOO_SLOWFAST = ZOO_PATHS['slowfast_r50_4x16x1']
ZOO_TPN_TSM = ZOO_PATHS['tpn_tsm_r50']
ZOO_NTHWC = tuple(ZOO + path for label, path, _ in ZOO_CONFIGS
                  if label != 'tpn_tsm_r50')
# a test-only config (data.test alone) refused at its data by the test CLI
ZOO_TEST_REFUSED = (ZOO + 'x3d/x3d_s_13x6x1_facebook_kinetics400_rgb.py',
                    'VideoDataset')
# recognition_extern: the TSN custom_backbones configs (ResNeXt-101 32x4d,
# DenseNet-161, Swin-B) card against CPU on one clip of their own train
# pipeline (3 segments at 224x224), held as recognition_2d holds its
# configs, with (label, file, the step check's clip cut as (frames, crop)
# or None: a cut where the CPU's float64 step on the own clip takes over
# ZOO_STEP_S, extern_step_costs); the planted faults; the CLI on TSN over
# Swin-B (RC_STEPS steps) and the test CLI on its checkpoint; a run of
# tsn_r50_1x1x3 derived with EXTERN_DERIVED through train_model (2 epochs
# of EXTERN_DERIVED_STEPS steps), resumed from its first epoch, and the
# tools on what it wrote
EXTERN = 'configs/recognition/tsn/custom_backbones/'
# the step checks of Swin-B at EXTERN_SWIN_DEPTHS (its third stage's 18
# blocks cut to 6, an even count: the shifted and the plain window
# alternate as they do) and of ResNeXt-101 at each stage's first
# EXTERN_STEP_BLOCKS blocks (33 to 8), the CPU's references shrinking with
# them; their full-depth logits held on the card against its float64
EXTERN_SWIN_DEPTHS = (2, 2, 6, 2)
EXTERN_STEP_BLOCKS = 2
EXTERN_CONFIGS = (   # the CPU's float64 step on the own clip: Swin-B 10.0
    # s, DenseNet-161 9.4, ResNeXt-101 7.6 (PERF.md): the first two cut to a
    # 160x160 crop of their 3 segments
    ('tsn_swin_base', 'tsn_swin_base_1x1x3_100e_kinetics400_rgb.py',
     (3, 160, EXTERN_SWIN_DEPTHS)),
    ('tsn_dense161', 'tsn_dense161_1x1x3_100e_kinetics400_rgb.py', (3, 160)),
    ('tsn_rn101_32x4d', 'tsn_rn101_32x4d_1x1x3_100e_kinetics400_rgb.py',
     (None, None, EXTERN_STEP_BLOCKS)))
EXTERN_DERIVED_BASE = RC2D + 'tsn/tsn_r50_1x1x3_100e_kinetics400_rgb.py'
EXTERN_DERIVED = {
    'optimizer': dict(_delete_=True, type='AdamW', lr=1e-3,
                      weight_decay=1e-2, paramwise_cfg=dict(
                          custom_keys=dict(bn=dict(decay_mult=0.0)))),
    'precise_bn': dict(num_iters=2, interval=1),
    'data.train.sample_by_class': True,
    'total_epochs': 2}
EXTERN_DERIVED_STEPS = 2
ABL_JSON_KEYS = {'arm', 'scale', 'seed', 'steps', 'batch', 'K', 'hw', 'T',
                 'n_videos', 'platform', 'init', 'final', 'losses'}


# every log line goes to LOG_PATH (the process's stdout is pointed there
# while the phases run, so the CLIs' lines and spawned ranks' go there too);
# the script's own stdout gets one summary line a phase, then the result
LOG_PATH = osp.join(osp.dirname(osp.abspath(__file__)), 'build',
                    'chip_smoke.log')
SUMMARY_BYTES = 1000
_RECORDS = []


def log(**kw):
    _RECORDS.append(kw)
    print(json.dumps(kw), flush=True)


def _short(v):
    return float(f'{v:.4g}') if isinstance(v, float) else v


def phase_summary(name, seconds, records):
    """One line for a phase that passed: its headline record if it logged
    one, else its records by kind and its first scalar numbers."""
    for r in reversed(records):
        if 'headline' in r:
            line = dict(phase=name, s=round(seconds, 1), **r['headline'])
            break
    else:
        kinds, head = {}, {}
        for r in records:
            kinds[r.get('phase')] = kinds.get(r.get('phase'), 0) + 1
            for k, v in r.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and k not in head and len(head) < 10:
                    head[k] = _short(v)
        line = dict(phase=name, s=round(seconds, 1), checks='passed',
                    records=kinds, head=head)
    return json.dumps(line)[:SUMMARY_BYTES]


def launch_ms(fn, iters=20, flush=None, warmup=3):
    """Device time of each of iters launches of fn (CUDA events around each
    launch), after a warm-up; with flush, L2 is overwritten before each.
    The device spins for about 0.1 ms before the start event, so the host
    has enqueued fn before the event is reached: the host's own time for
    the call (tens of microseconds in Python) stays out of the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, iters=20, flush=None, warmup=3):
    """Mean device time of fn over iters launches (launch_ms)."""
    return sum(launch_ms(fn, iters, flush, warmup)) / iters


def host_us(fn, iters=20):
    """Mean host time of a call of fn that only enqueues device work, in
    microseconds: what time_ms's spin must cover."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - start) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bound(bytes_moved, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_kernels(dev):
    """Each kernel against its plain version at the flagship shapes (the
    rows of the kernel table), a K the kernels refuse, each kernel's
    profiled device time, one plain read of the queue and the ptxas
    report; then the same check and timing at the batches of the other
    pretrain configs (KERNEL_BATCHES: logged as kernel_batch lines)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    q, queue, g, decay = kernel_inputs(dev, B)
    rows = kernel_rows(q, queue, g, decay, flush)
    # K=1000 is not a multiple of the 128-column K-tile
    ragged = queue[:, :1000].contiguous(), decay[:1000].contiguous()
    for fn, lhs in ((di.l_neg, q), (di.dq, g[:, :1000].contiguous())):
        try:
            fn(lhs, *ragged)
        except ValueError as e:
            if 'K-tile' not in str(e):
                raise
        else:
            raise AssertionError(f'{fn.__name__} took a ragged K')
    for row, kernel in zip(rows, (lambda: di.l_neg(q, queue, decay),
                                  lambda: di.dq(g, queue, decay))):
        row['launches_per_step'] = 7
        row['device_ms_by_kernel'] = device_ms_by_kernel(kernel, flush)
        log(phase='kernel', **row)
    # what one plain read of the queue takes under the same flush: the
    # practical floor of both kernels' bytes on this card
    log(phase='queue_read', bytes=4 * C * K,
        ms=time_ms(lambda: queue.sum(), flush=flush))
    log(phase='decayed_infonce_ptxas', launch=di.launch_info(C), kernels=[
        dict(v, kernel=ptxas_short(k)) for k, v in
        cuda_build.ptxas_report('decayed_infonce').items()])
    for b in KERNEL_BATCHES:
        for row in kernel_rows(*kernel_inputs(dev, b), flush):
            log(phase='kernel_batch', **row)
    return rows


def kernel_inputs(dev, b, c=C, k=K):
    """Unit-norm queries (b, c) and queue columns (c, k), a cotangent
    (b, k) and the decay weights of random counts, from seed 0."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, c)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    queue = rng.normal(size=(c, k)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    count = rng.integers(0, 65536, size=k)
    g = rng.normal(size=(b, k)).astype(np.float32)
    q, queue, g = (torch.from_numpy(x).to(dev) for x in (q, queue, g))
    return q, queue, g, di.decay_weights(torch.from_numpy(count).to(dev),
                                         0.99999)


def kernel_rows(q, queue, g, decay, flush):
    """l_neg and dq at q's batch against their plain versions and float64,
    each timed in turns with torch.matmul: one row a kernel."""
    b = q.shape[0]
    c, k = queue.shape
    qg = q.clone().requires_grad_(True)
    out = di.decayed_neg(qg, queue, decay)
    out.backward(g)
    want = di.l_neg_plain(q, queue, decay)
    want_dq = di.dq_plain(g, queue, decay)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.detach(), want, **FWD_TOL)
    torch.testing.assert_close(qg.grad, want_dq, **DQ_TOL)
    # both against float64, so an exact agreement with the plain version
    # (cuBLAS may sum in the kernel's order) is not the only evidence
    w64 = queue.double() * decay.double()
    err64 = {}
    for name, got, ref in (('l_neg', out.detach(), q.double() @ w64),
                           ('dq', qg.grad, g.double() @ w64.T)):
        err = (got.double() - ref).abs().max().item()
        limit = F64_REL * ref.abs().max().item()
        err64[name], err64[name + '_limit'] = err, limit
        if not err <= limit:
            raise AssertionError(f'{name} at B={b}, C={c}, K={k}: {err} '
                                 f'from float64 > {limit}')
    log(phase='kernel_vs_float64', batch=b, C=c, K=k, **err64)

    w = queue * decay
    f4 = 4
    rows = []
    for name, kernel, plain, library, err, nbytes in (
            ('decayed_infonce_l_neg', lambda: di.l_neg(q, queue, decay),
             lambda: di.l_neg_plain(q, queue, decay),
             lambda: torch.matmul(q, w),
             (out.detach() - want).abs().max().item(),
             f4 * (b * c + c * k + k + b * k)),
            ('decayed_infonce_dq', lambda: di.dq(g, queue, decay),
             lambda: di.dq_plain(g, queue, decay),
             lambda: torch.matmul(g, w.T),
             (qg.grad - want_dq).abs().max().item(),
             f4 * (b * k + c * k + k + b * c))):
        bound_ms, bound_by = bound(nbytes, 2 * b * c * k + c * k)
        # kernel and library in turns on this card: kernel, library,
        # library, kernel, after one untimed round of each (the first
        # timed turn ran slow without it); each the mean of its two turns
        for fn in (kernel, library):
            time_ms(fn, iters=5, flush=flush)
        turns = [time_ms(fn, flush=flush)
                 for fn in (kernel, library, library, kernel)]
        row = dict(name=name, batch=b, C=c, K=k, max_abs_err=err,
                   kernel_ms=(turns[0] + turns[3]) / 2,
                   library_ms=(turns[1] + turns[2]) / 2,
                   turns_ms=turns, plain_ms=time_ms(plain, flush=flush),
                   bound_ms=bound_ms, bound_by=bound_by)
        row['bound_share'] = bound_ms / row['kernel_ms']
        rows.append(row)
    return rows


def device_ms_by_kernel(fn, flush):
    """Device time of each kernel that one call of fn runs, L2 flushed."""
    from torch.profiler import ProfilerActivity
    flush.zero_()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ptxas_short(e.key): device_us(e) / 1e3 for e in prof.key_averages()
            if getattr(e, 'device_type', None) ==
            torch.autograd.DeviceType.CUDA}


def device_us(event):
    us = getattr(event, 'self_device_time_total', None)
    return getattr(event, 'self_cuda_time_total', 0.0) if us is None else us


def reset_launch_counts():
    di.l_neg.launches = di.dq.launches = cl.corr_lookup.launches = 0
    for fn in mf.ENTRY_POINTS.values():
        fn.launches = 0


def corr_inputs(dev, n, h, w, seed):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.normal(size=(n, h, w, CORR_C)).astype(np.float32)
              for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=8.0, size=(n, h, w, 2))
    return (torch.from_numpy(x).to(dev) for x in
            (f1, f2, coords.astype(np.float32)))


def smooth_coords(dev, n, h, w):
    """The grid plus a smooth flow of amplitude 8, as a real flow field is
    (neighbouring windows overlap, unlike under per-pixel noise)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    flow = 8 * np.stack([np.sin(ys / 5.0), np.cos(xs / 7.0)], -1)
    coords = (np.stack([xs, ys], -1) + flow)[None].repeat(n, 0)
    return torch.from_numpy(coords.astype(np.float32)).to(dev)


def corr_corners(coords, h, w):
    """In-range integer corners that the lookup at these coords reads, over
    all levels: 2*C operations each."""
    kc, total = 2 * CORR_RADIUS + 2, 0
    for l in range(CORR_LEVELS):
        start = torch.floor(coords / 2 ** l).clamp(-65536, 65536) - \
            CORR_RADIUS
        span = []
        for i, size in ((0, w >> l), (1, h >> l)):
            lo = start[..., i].clamp(min=0)
            hi = (start[..., i] + kc).clamp(max=size)
            span.append((hi - lo).clamp(min=0))
        total += int((span[0] * span[1]).sum().item())
    return total


def wide_coords(dev, n, h, w, seed):
    """The grid plus normal noise of scale CORR_WIDE_SCALE: each tile's
    window union spreads over most of a level, beyond one stage."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=CORR_WIDE_SCALE, size=(n, h, w, 2))
    return torch.from_numpy(coords.astype(np.float32)).to(dev)


def corr_check(name, f1, pyr, coords):
    """The lookup kernel at these coords against its plain version and
    float64; two calls must give the same bits. Returns its errors."""
    out = cl.corr_lookup(f1, pyr, coords, CORR_LEVELS, CORR_RADIUS)
    again = cl.corr_lookup(f1, pyr, coords, CORR_LEVELS, CORR_RADIUS)
    want = cl.corr_lookup_plain(f1, pyr.levels, coords, CORR_RADIUS)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **CORR_TOL)
    if not torch.equal(out, again):
        raise AssertionError(f'corr_lookup {name}: two calls differ')
    ref = cl.corr_lookup_plain(f1.double(), [v.double() for v in pyr.levels],
                               coords.double(), CORR_RADIUS)
    err64 = (out.double() - ref).abs().max().item()
    limit = F64_REL * ref.abs().max().item()
    if not err64 <= limit:
        raise AssertionError(f'corr_lookup {name}: {err64} from float64 > '
                             f'{limit}')
    return dict(max_abs_err=(out - want).abs().max().item(), f64_err=err64,
                f64_limit=limit), out


def corr_traffic(coords, h, w):
    """What the lookup at these coords reads on chip: its in-range corners,
    the bytes a per-corner gather of f2 rows would move, and the bytes the
    kernel's tiles stage from L2 (and their union boxes would), counted on
    the host from its tile plan."""
    corners = corr_corners(coords, h, w)
    staged, boxed = cl.staged_positions(coords, CORR_LEVELS, CORR_RADIUS)
    row = 4 * CORR_C
    return dict(corners=corners, gather_bytes=corners * row,
                staged_bytes=staged * row, box_bytes=boxed * row)


def phase_corr_lookup(dev):
    """The lookup kernel against its plain version and float64, at the
    extraction shape and at RAFT's 440x1024, with noisy, smooth and (at
    440x1024) wide flows, and far off the image; timed with L2 flushed."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for i, (name, n, h, w) in enumerate(CORR_SHAPES):
        f1, f2, coords = corr_inputs(dev, n, h, w, seed=10 + i)
        pyr = cl.corr_pyramid(f2, CORR_LEVELS)
        flows = dict(noise=coords, smooth=smooth_coords(dev, n, h, w))
        if name == CORR_WIDE_SHAPE:
            flows['wide'] = wide_coords(dev, n, h, w, seed=20 + i)
        # level 0 alone: what the coarser levels add to a call
        pyr0 = cl.corr_pyramid(f2, 1)
        checks = {}
        for flow, cds in flows.items():
            errs, out = corr_check(f'{name} {flow}', f1, pyr, cds)

            def call(cds=cds):
                return cl.corr_lookup(f1, pyr, cds, CORR_LEVELS, CORR_RADIUS)
            checks[flow] = dict(
                errs, **corr_traffic(cds, h, w),
                kernel_ms=time_ms(call, flush=flush),
                level0_ms=time_ms(lambda cds=cds: cl.corr_lookup(
                    f1, pyr0, cds, 1, CORR_RADIUS), flush=flush),
                host_us=host_us(call))
            log(phase='corr_lookup_flow', shape=name, flow=flow,
                **checks[flow])
        far = cl.corr_lookup(f1, pyr, torch.full_like(coords, -1000.0),
                             CORR_LEVELS, CORR_RADIUS)
        if far.any():
            raise AssertionError(f'corr_lookup {name}: nonzero far off the '
                                 'image')
        noise = checks['noise']
        nbytes = 4 * (f1.numel() + pyr.flat.numel() + coords.numel() +
                      out.numel())
        bound_ms, bound_by = bound(nbytes, 2 * CORR_C * noise['corners'])
        row = dict(
            shape=name, n=n, h=h, w=w, max_abs_err=max(
                c['max_abs_err'] for c in checks.values()),
            f64_err=noise['f64_err'], f64_limit=noise['f64_limit'],
            corners=noise['corners'],
            corners_max=n * h * w * CORR_LEVELS * (2 * CORR_RADIUS + 2) ** 2,
            bytes=nbytes, kernel_ms=noise['kernel_ms'],
            kernel_ms_smooth=checks['smooth']['kernel_ms'],
            corners_smooth=checks['smooth']['corners'],
            plain_ms=time_ms(lambda: cl.corr_lookup_plain(
                f1, pyr.levels, coords, CORR_RADIUS), iters=5, flush=flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            plan=cl.plan(n, h, w, CORR_C, CORR_RADIUS))
        log(phase='corr_lookup_kernel', **row)
        rows[name] = row
    corr_ptxas()
    return rows


def corr_ptxas():
    """The lookup kernel's registers, spills and shared memory (ptxas) and
    its launch (the library's own report, which must agree with the host's
    plan); no spill, and its staging copies in the SASS (LDGSTS, or UTMALDG
    for a TMA design)."""
    info = cl.launch_info(CORR_C, CORR_RADIUS)
    plan = cl.plan(1, 16, 16, CORR_C, CORR_RADIUS)
    report = [dict(v, kernel=ptxas_short(k)) for k, v in
              cuda_build.ptxas_report('corr_lookup').items()]
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(cuda_build.library_path(
        'corr_lookup'))], capture_output=True, text=True, check=True).stdout
    ops = {op: len(re.findall(op + r'\b', sass))
           for op in ('LDGSTS', 'UTMALDG', 'LDS', 'FFMA')}
    log(phase='corr_lookup_ptxas', launch=info, kernels=report, sass=ops)
    spilled = [r['kernel'] for r in report if r.get('spill_store_bytes', 1)
               or r.get('spill_load_bytes', 1)]
    if spilled or not report:
        raise AssertionError(f'corr_lookup kernels spill: {spilled}')
    if not ops['LDGSTS'] + ops['UTMALDG']:
        raise AssertionError(f'corr_lookup SASS stages nothing: {ops}')
    mismatch = {k: (info[k], plan[k]) for k in plan if k in info and
                info[k] != plan[k]}
    if mismatch or info['blocks_per_sm'] < 1:
        raise AssertionError(f'corr_lookup launch {info} against plan '
                             f'{plan}: {mismatch}')


def mxu_check(dev, case):
    """A probe's kernel at MXU_STEPS steps against its plain version, and
    both against float64, at the tool's M and inputs."""
    x, w = bm.inputs(case, dev)
    shape = dict(m=bm.M, **case.shape)
    got = bm.call(case, x, w, steps=MXU_STEPS)
    want = mf.PLAIN_VERSIONS[case.kind](x, w, **shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **MXU_TOL)
    ref = mf.reference(case.kind, x, w, **shape)
    limit = MXU_F64_REL * ref.abs().max().item()
    errs = {}
    for label, out in (('f64_err', got), ('plain_f64_err', want)):
        errs[label] = (out.double() - ref).abs().max().item()
        if not errs[label] <= limit:
            raise AssertionError(f'{case.name}: {label} {errs[label]} > '
                                 f'{limit}')
    return x, w, dict(errs, f64_limit=limit, max_abs_err=(
        got.float() - want.float()).abs().max().item())


def bigdot_library(x, w, flush):
    """One torch.matmul computing the MXU_STEPS products of a bigdot launch
    on a stride-0 batch of x and w, timed, and the device kernels it runs."""
    from torch.profiler import ProfilerActivity
    xb, wb = x.expand(MXU_STEPS, *x.shape), w.expand(MXU_STEPS, *w.shape)
    ms = time_ms(lambda: torch.matmul(xb, wb), flush=flush)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.matmul(xb, wb)
        torch.cuda.synchronize()
    kernels = sorted({e.key[:90] for e in prof.key_averages() if getattr(
        e, 'device_type', None) == torch.autograd.DeviceType.CUDA})
    return ms, kernels


def ptxas_short(kernel):
    """A kernel's mangled name as name<template arguments>."""
    m = re.search(r'([a-z][a-z_]*_kernel)((?:IL[ib]\d+E(?:L[ib]\d+E)*E)?)',
                  kernel)
    if not m:
        return kernel
    args = re.findall(r'L[ib](\d+)E', m[2])
    return f'{m[1]}<{", ".join(args)}>' if args else m[1]


def l2_bytes(case, plan):
    """Bytes a probe's kernel reads from L2 in a launch, by its design: each
    unit reads its rows of x (bigdot: its tile's rows; the others their
    (BM+8)-row slab) and all of w once."""
    s, units = case.shape, plan['units']
    depth = s['k'] * s.get('inner', 1)
    x_rows = (bm.M * MXU_STEPS if case.kind == 'bigdot' else
              units * (plan['bm'] + 8))
    return 2 * (x_rows * s['k'] + units * depth * s['n'])


def kernel_name(case, plan):
    """The instantiation a case's plan launches, as ptxas_short names it."""
    n, rows = case.shape['n'], plan['bm']
    if case.kind in ('bigdot', 'imcat'):
        return f"kcat_gemm_kernel<{n}, {rows}, {int(case.kind == 'imcat')}>"
    return f"tap_wgmma_kernel<{n}, {rows}, {int(case.kind != 'carry')}>"


def mxu_schedule(case, x, w, flush):
    """A probe's persistent schedule: its plan, the L2 bytes it implies,
    the time at half the steps (each step's work must run), and the host's
    time for a call. The steps are compared by their fastest launches, which
    a stall of the host (the card shares it) cannot lengthen."""
    plan = mf.plan(case.kind, bm.M, steps=MXU_STEPS, **case.shape)
    ms = {st: min(launch_ms(lambda: bm.call(case, x, w, steps=st),
                            flush=flush))
          for st in (MXU_STEPS // 2, MXU_STEPS)}
    ratio = ms[MXU_STEPS] / ms[MXU_STEPS // 2]
    l2 = l2_bytes(case, plan)
    log(phase='mxu_schedule', case=case.name.strip(),
        kernel=kernel_name(case, plan), **plan, ms_by_steps=ms,
        steps_ratio=ratio, l2_bytes=l2, l2_tb_per_s=l2 / ms[MXU_STEPS] / 1e9,
        host_us=host_us(lambda: bm.call(case, x, w, steps=MXU_STEPS)))
    lo, hi = STEPS_RATIO
    if not lo <= ratio <= hi:
        raise AssertionError(f'{case.name}: {MXU_STEPS} steps take {ratio:.2f}'
                             f'x the time of {MXU_STEPS // 2}')


def mxu_sass():
    """The SASS of the built fill-probe kernels: each must issue wgmma
    (HGMMA) and TMA loads (UTMALDG), and none mma.sync (HMMA); the tap
    kernels with their accumulator in shared memory (probe, paircat) must
    also load and store it there (LDS, STS)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(cuda_build.library_path(
        'mxu_fill'))], capture_output=True, text=True, check=True).stdout
    counts = {}
    for sec in re.split(r'\n\s*Function : ', sass)[1:]:
        name = ptxas_short(sec.split('\n', 1)[0].strip())
        counts[name] = {op: len(re.findall(op + r'\b', sec))
                        for op in ('HGMMA', 'UTMALDG', 'HMMA', 'LDS', 'STS')}
    log(phase='mxu_sass', kernels=counts)
    # kcat: bigdot at 256 rows, imcat at 128 and 256; tap: the shared
    # accumulator at 256 rows (N=64) and 128 (N=128), carry at 128 and 256;
    # each at N = 64 and 128
    bad = [k for k, c in counts.items()
           if c['HGMMA'] == 0 or c['UTMALDG'] == 0 or c['HMMA'] or
           (k.startswith('tap_wgmma_kernel') and k.endswith(', 1>') and
            (c['LDS'] == 0 or c['STS'] == 0))]
    kinds = sorted(k.split('<')[0] for k in counts)
    if bad or kinds != ['kcat_gemm_kernel'] * 6 + ['tap_wgmma_kernel'] * 6:
        raise AssertionError(f'mxu_fill SASS: {counts}')


def phase_mxu_fill(dev):
    """Each fill-probe kernel against its plain version and float64 at the
    first case of its case list, then timed at MXU_STEPS steps with L2
    flushed beside its plain version (and bigdot beside torch.matmul)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for name, mode, index in MXU_ROWS:
        case = bm.cases(mode)[index]
        x, w, errs = mxu_check(dev, case)
        flops = bm.flops_per_pass(case) * MXU_STEPS
        nbytes = 2 * (x.numel() + w.numel() + bm.M * case.shape['n'])
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        kernel_ms = time_ms(lambda: bm.call(case, x, w, steps=MXU_STEPS),
                            flush=flush)
        plain_ms = time_ms(lambda: mf.PLAIN_VERSIONS[case.kind](
            x, w, m=bm.M, steps=MXU_STEPS, **case.shape), iters=2, warmup=1,
            flush=flush)
        library_ms, library_kernels = (bigdot_library(x, w, flush)
                                       if case.kind == 'bigdot' else
                                       (None, None))
        row = dict(name=name, case=case.name.strip(), steps=MXU_STEPS,
                   kernel_ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                   peak_share=bound_ms / kernel_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, library_kernels=library_kernels,
                   **errs)
        log(phase='mxu_fill_kernel', **row)
        check_rate(row['case'], row['tflops'])
        rows[name] = row
        mxu_schedule(case, x, w, flush)
    # carry at mt=1624: 13 sub-tiles of 128 rows a tile (an accumulator of
    # all 1624 rows in registers would spill)
    case = bm.cases('carry')[4]
    x, w, errs = mxu_check(dev, case)
    kernel_ms = time_ms(lambda: bm.call(case, x, w, steps=MXU_STEPS),
                        flush=flush)
    log(phase='mxu_fill_check', case=case.name.strip(), steps=MXU_STEPS,
        kernel_ms=kernel_ms, tflops=bm.flops_per_pass(case) * MXU_STEPS /
        kernel_ms / 1e9, bound_ms=bound(0, bm.flops_per_pass(case) *
                                        MXU_STEPS, BF16_FLOP_PER_S)[0],
        **errs)
    mxu_schedule(case, x, w, flush)
    plans = {}
    for mode in ('', 'carry', 'kchain'):
        for case in bm.cases(mode):
            plan = mf.plan(case.kind, bm.M, steps=MXU_STEPS, **case.shape)
            plans.setdefault(kernel_name(case, plan), []).append(
                dict(plan, case=case.name.strip()))
    report = [dict(v, kernel=ptxas_short(k),
                   plans=plans.get(ptxas_short(k), []))
              for k, v in cuda_build.ptxas_report('mxu_fill').items()]
    log(phase='mxu_fill_ptxas', kernels=report)
    spilled = [r['kernel'] for r in report if r.get('spill_store_bytes', 1)
               or r.get('spill_load_bytes', 1)]
    if spilled or not report:
        raise AssertionError(f'mxu_fill kernels spill: {spilled}')
    mxu_sass()
    return rows


def check_rate(case, tflops):
    if not tflops < BF16_FLOP_PER_S / 1e12:
        raise AssertionError(f'{case}: {tflops} TF/s is above the card\'s '
                             'peak: some of its work did not run')


def phase_mxu_fill_tool():
    """The probe tool's three case lists through its main(), at its own
    steps and iters; returns each kernel's launches in that run."""
    reset_launch_counts()
    results = []
    for flags in ([], ['--carry'], ['--kchain']):
        results += bm.main(flags + ['--iters', str(MXU_CLI_ITERS)])
    launches = {kind: fn.launches for kind, fn in mf.ENTRY_POINTS.items()}
    want = dict.fromkeys(mf.ENTRY_POINTS, 0)
    for mode in ('', 'carry', 'kchain'):
        for case in bm.cases(mode):
            want[case.kind] += MXU_CLI_ITERS + 1
    for r in results:
        log(phase='mxu_fill_tool', **r)
        check_rate(r['name'], r['tflops'])
    if launches != want:
        raise AssertionError(f'probe launches {launches} != {want}')
    return launches


def phase_conv_yardstick(dev):
    """cuDNN's r3d_18 layer1 convolution at the flagship shape, in bf16
    channels-last-3d and in float32 with TF32 off (as the step runs it)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(CONV_SHAPE, device=dev, generator=g)
    wt = 0.05 * torch.randn((64, 64, 3, 3, 3), device=dev, generator=g)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        fp32_ms = time_ms(lambda: F.conv3d(x, wt, padding=1), iters=10)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    xb, wb = (t.to(dtype=torch.bfloat16, memory_format=torch.channels_last_3d)
              for t in (x, wt))
    bf16_ms = time_ms(lambda: F.conv3d(xb, wb, padding=1), iters=10)
    log(phase='conv_yardstick', shape=list(CONV_SHAPE), out_channels=64,
        gflop=CONV_FLOP / 1e9, bf16_channels_last_ms=bf16_ms,
        bf16_tflops=CONV_FLOP / bf16_ms / 1e9, fp32_no_tf32_ms=fp32_ms,
        fp32_tflops=CONV_FLOP / fp32_ms / 1e9)


def tree_to(x, device):
    """Every tensor of a nested dict of draws, moved to device."""
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def wheel_check(name, got, want, step=WHEEL_STEP):
    """A visualised flow against another: at most a 1/255 step, on a share
    of at most WHEEL_SHARE of the elements (rounded up to one)."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    flips = int((diff > 1e-6).sum())
    if diff.max() > step or flips > max(1, int(WHEEL_SHARE * diff.numel())):
        raise AssertionError(f'{name}: largest gap {float(diff.max())}, '
                             f'{flips} of {diff.numel()} elements off')
    return float(diff.max()), flips


def aug_inputs(dev, dtype, seed=5):
    """The flagship batch's clips and flows as the step hands them to the
    aug: (im_q, im_k, aux_info) in dtype on dev."""
    batch = flagship_batch(32, seed=seed)
    im_q, im_k = (torch.from_numpy(x).to(dev, dtype) for x in batch['imgs'])
    aux = {f'flow_imgs_{s}': torch.from_numpy(x).to(dev, dtype)
           for s, x in zip('qk', batch['flow_imgs'])}
    return im_q, im_k, aux


def aug_rates(draws):
    """Share of clips each apply decision of one V5 branch took."""
    strong = draws['strong']
    return dict(flip=draws['flip'], jitter=strong['jitter']['apply'],
                gray=strong['gray']['apply'], blur=strong['blur']['apply'])


def phase_ssl_aug(dev):
    """The flagship config's aug at the flagship batch: card against CPU on
    the same draws, the card generator's rates, its device time, and no
    host synchronisation in a call."""
    aug = build_ssl_aug(load_flagship_config().model.to_dict()['aug'])
    torch.backends.cudnn.allow_tf32 = False      # as the step runs it
    gen = torch.Generator(device=dev).manual_seed(7)
    card, cpu = aug_inputs(dev, torch.float32), aug_inputs('cpu',
                                                           torch.float32)
    draws = aug.draw(gen, card[0], card[1])
    got = aug.apply(*card, draws)
    want = aug.apply(*cpu, tree_to(draws, 'cpu'))
    img_err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got[:2], want[:2]))
    if img_err > AUG_TOL:
        raise AssertionError(f'ssl_aug clips: card vs CPU {img_err}')
    flow = {k: wheel_check(k, got[2][k], want[2][k]) for k in want[2]}
    if any(got[2][k].shape[1] != 3 for k in want[2]):
        raise AssertionError('the flagship aug must visualise the flow')

    big = torch.zeros(RATE_B, 3, 2, 1, 1, device=dev)
    rate_draws = aug.draw(torch.Generator(device=dev).manual_seed(8), big, big)
    rates = {}
    for branch in 'qk':
        for name, taken in aug_rates(rate_draws[branch]).items():
            p, rate = AUG_RATES[name], float(taken.float().mean())
            rates[f'{branch}_{name}'] = rate
            if abs(rate - p) > 4 * math.sqrt(p * (1 - p) / RATE_B):
                raise AssertionError(f'{branch} {name} rate {rate} vs {p}')

    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = aug_inputs(dev, dtype)
        name = str(dtype).split('.')[-1]
        timing[f'{name}_ms'] = time_ms(lambda: aug(gen, *inputs), iters=10)
        out = aug(gen, *inputs)
        if out[0].dtype != dtype or out[2]['flow_imgs_q'].dtype != dtype:
            raise AssertionError(f'ssl_aug output dtype in a {dtype} call')
    # bytes the aug must move at least: each clip and flow read once, each
    # output written once (flows leave with 3 channels), in float32
    n_img, n_flow = (sum(x.numel() for x in card[:2]),
                     sum(x.numel() for x in card[2].values()))
    min_bytes = 4 * (2 * n_img + n_flow * 5 // 2)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        aug(gen, *card)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log(phase='ssl_aug', aug=type(aug).__name__, batch=32,
        card_vs_cpu_max_abs_clip=img_err,
        card_vs_cpu_flow={k: dict(max_abs=v[0], flips=v[1])
                          for k, v in flow.items()},
        rates_b4096=rates, **timing, min_bytes=min_bytes,
        bytes_bound_ms=min_bytes / HBM_BYTES_PER_S * 1e3,
        sync_debug='error: no host synchronisation')


def replayed_draws(aug, batches, seed):
    """One set of the aug's draws for each batch, made once on the CPU, so
    that the card and the CPU run the same augmentation."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for batch in batches:
        im = torch.from_numpy(batch['imgs'][0])
        out.append(aug.draw(gen, im, im))
    return out


def phase_card_vs_cpu():
    """Two train steps of a narrow model on the card and on the CPU, from
    the same weights and batches, with IdentityAug and with V5 (the same
    draws on both)."""
    batches = [flagship_batch(4, hw=32, seed=s) for s in (1, 2)]
    for aug_cfg in (dict(type='IdentityAug'), dict(FLAGSHIP_AUG,
                                                   crop_size=32)):
        card_vs_cpu(narrow_flagship_cfg(aug=aug_cfg), batches)


def card_vs_cpu(cfg, batches, name=None, required=None):
    """Two train steps of cfg's model on the CPU and on the card from the
    same weights and batches (a device aug fed the same draws on both):
    every loss (``required``, by default STEP_LOSSES of its recognizer, at
    least) and every queue within STEP_TOL."""
    logs = {}
    draws = None
    for dev in ('cpu', 'cuda'):
        model = build_model_from_cfg(cfg, device=dev, seed=1)
        # ShuffleBN's permutations from one CPU generator, alike on both
        perm_gen = torch.Generator().manual_seed(5)
        for _, tower in towers(model):
            tower.draw_shuffle = (lambda gen, b, device, g=perm_gen:
                                  torch.randperm(b, generator=g).to(device))
        if cfg['aug']['type'] != 'IdentityAug':
            if draws is None:
                draws = replayed_draws(model.aug, batches, seed=3)
            queue = iter(draws)
            model.aug.draw = (lambda gen, im_q, im_k, aux_info=None, q=queue:
                              tree_to(next(q), im_q.device))
        opt = build_optimizer(
            model, dict(type='SGD', lr=0.02, momentum=0.9,
                        weight_decay=1e-4),
            build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.02,
                              400, 100),
            grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
        step = make_train_step(model, opt, build_ema_fn(model))
        logs[dev] = [{k: v.item() for k, v in step(to_torch(
            batch, dev)).items()} for batch in batches]
        logs[dev + '_queue'] = {k: v.cpu() for k, v in
                                model.state_dict().items()
                                if k.endswith('queue')}
    worst = 0.0
    required = STEP_LOSSES[cfg['type']] if required is None else required
    for cpu, card in zip(logs['cpu'], logs['cuda']):
        if sorted(cpu) != sorted(card):
            raise AssertionError(f'logged {sorted(card)} != {sorted(cpu)}')
        missing = [k for k in required if k not in cpu]
        if missing:
            raise AssertionError(f'{cfg["type"]} logged no {missing}')
        for k in (k for k in cpu if k.startswith('loss')):
            torch.testing.assert_close(torch.tensor(card[k]),
                                       torch.tensor(cpu[k]), **STEP_TOL)
            worst = max(worst, abs(card[k] - cpu[k]))
    for k, v in logs['cpu_queue'].items():
        torch.testing.assert_close(logs['cuda_queue'][k], v, **STEP_TOL)
    log(phase='card_vs_cpu', model=name or cfg['type'],
        aug=cfg['aug']['type'], steps=2, max_abs_loss_diff=worst,
        **{f'loss_step{i + 1}': v['loss'] for i, v in
           enumerate(logs['cuda'])})


def phase_raft_card_vs_cpu():
    """RAFT at full width on the card and on the CPU, from the same seeded
    weights and images: 64x64, 4 levels, radius 4, 3 iterations."""
    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)
    img2 = np.roll(img1, (3, -2), axis=(2, 3)) + rng.normal(
        scale=4.0, size=img1.shape).astype(np.float32)
    flows = {}
    for dev in ('cpu', 'cuda'):
        model = build_raft(device=dev, seed=1, iters=3)
        with torch.inference_mode():
            flows[dev] = [f.cpu() for f in model(*(
                torch.from_numpy(x).to(dev) for x in (img1, img2)))]
    for cpu, card in zip(flows['cpu'], flows['cuda']):
        torch.testing.assert_close(card, cpu, **RAFT_TOL)
    diff = [(card - cpu).abs().max().item()
            for cpu, card in zip(flows['cpu'], flows['cuda'])]
    log(phase='raft_card_vs_cpu', hw=64, iters=3,
        max_abs_flow=flows['cpu'][1].abs().max().item(),
        max_abs_diff_low=diff[0], max_abs_diff_up=diff[1])


def phase_flagship(dev, dtype):
    """The flagship config's own model (SyncMoCoAugmentV5, 3-channel flow
    stem) in the compute dtype."""
    cfg = load_flagship_config()
    model = build_model_from_cfg(cfg.model.to_dict(), device=dev, seed=0,
                                 dtype=dtype)
    if model.recognizer_flow.encoder_q.stem[0].in_channels != 3:
        raise AssertionError('the flagship flow stem must take 3 channels')
    bs = cfg.data['videos_per_gpu']
    lr = build_lr_schedule(cfg.lr_config.to_dict(), cfg.optimizer['lr'],
                           cfg.total_epochs, cfg.dataset_size // bs)
    opt = build_optimizer(model, cfg.optimizer.to_dict(), lr,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    batch = to_torch(flagship_batch(bs, seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    step_ms, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        log_vars = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in log_vars.items()})
    launches = dict(l_neg=di.l_neg.launches, dq=di.dq.launches)

    for i, lv in enumerate(losses):
        missing = [k for k in LOSS_KEYS if k not in lv]
        bad = [k for k in LOSS_KEYS + ['loss'] if not math.isfinite(lv[k])]
        if missing or bad:
            raise AssertionError(f'step {i + 1}: missing {missing}, '
                                 f'non-finite {bad}')
    state = {f'{t}.{n}': int(getattr(getattr(model, t), n))
             for t in ('recognizer', 'recognizer_flow')
             for n in ('queue_ptr', 'iters')}
    want = {'recognizer.queue_ptr': STEPS * bs,
            'recognizer_flow.queue_ptr': STEPS * bs,
            'recognizer.iters': STEPS * bs,
            'recognizer_flow.iters': 2 * STEPS * bs}
    if state != want:
        raise AssertionError(f'moco state {state} != {want}')
    if launches != dict(l_neg=7 * STEPS, dq=7 * STEPS):
        raise AssertionError(f'kernel launches {launches} != {7 * STEPS} '
                             'each')
    peak = torch.cuda.max_memory_allocated()
    name = str(dtype).split('.')[-1]
    log(phase='flagship_step', dtype=name, aug=type(model.aug).__name__,
        steps=STEPS, batch=bs, K=model.recognizer.K, step_ms=step_ms,
        peak_bytes=peak, launches=launches, state=state,
        losses=[{k: lv[k] for k in LOSS_KEYS + ['loss']} for lv in losses])
    profile(f'flagship_step_{name}', lambda: step(batch))
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches


def phase_flow_extraction():
    """RAFT large through the extraction entry point, on synthetic frame
    pairs (the second frame the first shifted, plus noise)."""
    raft_fn = make_raft_fn(None, iters=RAFT_ITERS)
    rng = np.random.default_rng(3)
    h, w = EXTRACT_HW
    batches = []
    for _ in range(EXTRACT_BATCHES):
        img1 = rng.integers(0, 256, (EXTRACT_PAIRS, h, w, 3), dtype=np.uint8)
        img2 = np.clip(np.roll(img1, (2, -3), axis=(1, 2)).astype(np.int16) +
                       rng.integers(-8, 9, img1.shape), 0, 255).astype(
                           np.uint8)
        batches.append((img1, img2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    batch_ms, flow_max = [], 0.0
    for img1, img2 in batches:
        t0 = time.perf_counter()
        flow = raft_fn(img1, img2)       # numpy: the copy back synchronises
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if flow.shape != (EXTRACT_PAIRS, h, w, 2) or \
                not np.isfinite(flow).all():
            raise AssertionError(f'flow {flow.shape}, finite '
                                 f'{np.isfinite(flow).all()}')
        flow_max = max(flow_max, float(np.abs(flow).max()))
    launches = cl.corr_lookup.launches
    if launches != RAFT_ITERS * EXTRACT_BATCHES:
        raise AssertionError(f'corr_lookup launches {launches} != '
                             f'{RAFT_ITERS * EXTRACT_BATCHES}')
    steady = batch_ms[1:]
    log(phase='flow_extraction', batches=EXTRACT_BATCHES,
        pairs=EXTRACT_PAIRS, hw=list(EXTRACT_HW), iters=RAFT_ITERS,
        batch_ms=batch_ms,
        pairs_per_s=EXTRACT_PAIRS * len(steady) / sum(steady) * 1e3,
        peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        max_abs_flow=flow_max)
    profile('flow_extraction', lambda: raft_fn(*batches[0]))
    return launches


def png_filter_rows(img, kinds=None):
    """Each row of an 8-bit RGB image filtered by the type in ``kinds``,
    or, without it, as libpng's adaptive choice does it (and cv2 with
    IMWRITE_PNG_ALL_FILTERS): of the five filters, the one whose residuals,
    read as signed bytes, have the least sum of magnitudes. Returns (filter
    type of each row, the filtered rows)."""
    x = img.astype(np.int16)
    h = x.shape[0]
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, 1:], up[1:], upleft[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cand = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                     x - paeth]).reshape(5, h, -1) % 256
    if kinds is None:
        kinds = np.minimum(cand, 256 - cand).sum(2).argmin(0)
    return kinds, cand[kinds, np.arange(h)].astype(np.uint8)


def write_png(path, img, kinds=None):
    """An 8-bit RGB PNG, each row's filter ``kinds`` or chosen adaptively
    (zlib, level 1). Returns the filter type of each row."""
    h, w, _ = img.shape
    kinds, filt = png_filter_rows(img, kinds)
    rows = np.concatenate([kinds[:, None].astype(np.uint8), filt], 1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' +
                chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)) +
                chunk(b'IDAT', zlib.compress(rows.tobytes(), 1)) +
                chunk(b'IEND', b''))
    return kinds


def write_video(root, v, hw=CLI_FRAME_HW, n_frames=CLI_FRAME_FILES,
                n_flows=CLI_FLOW_FILES):
    """One video: n_frames PNGs of hw whose 32-row bands alternate a colour
    ramp with little noise and a colour wave with more (so the adaptive
    writer picks Up, Paeth and Avg rows, as on camera frames), n_flows
    .npy flows. Returns (frames, flows, filter rows by type, bytes)."""
    rng = np.random.default_rng((11, v))
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = yy[..., None] + 2 * xx[..., None] + np.array([0, 60, 120])
    wave = 128 + 60 * np.sin(xx[..., None] / 23 + np.array([0, 1, 2])) * \
        np.cos(yy[..., None] / 17)
    band = ((yy // 32) % 2 == 0)[..., None]
    vdir = osp.join(root, f'video_{v:03d}')
    os.makedirs(vdir)
    frames, flows, kinds = [], [], np.zeros(5, np.int64)
    for i in range(n_frames):
        img = np.where(band ^ bool(i % 2),
                       (ramp + 7 * v + 11 * i +
                        rng.integers(0, 6, (h, w, 3))) % 256,
                       np.clip(wave + 4 * i + rng.normal(0, 8, (h, w, 3)),
                               0, 255))
        frames.append(osp.join(vdir, f'img_{i:05d}.png'))
        kinds += np.bincount(write_png(frames[-1], img.astype(np.uint8)),
                             minlength=5)
    for i in range(n_flows):
        flows.append(osp.join(vdir, f'flow_{i:05d}.npy'))
        np.save(flows[-1], rng.normal(
            scale=3.0, size=CLI_FLOW_HW + (2,)).astype(np.float32))
    return (frames, flows, kinds,
            sum(osp.getsize(p) for p in frames + flows))


def write_rawframes(root):
    """CLI_VIDEOS videos (written by 8 threads) of CLI_LIST frame entries
    cycling over CLI_FRAME_FILES PNGs each, the
    len(range(0, CLI_LIST - 8, 2)) flows MatchFlow(gap=2, adjacent=8)
    wants cycling over CLI_FLOW_FILES .npy files, an MDS-like chosen_idx; a
    train pickle that lists the videos CLI_REPEAT times (CLI_REPEAT * 2
    steps an epoch) and a val pickle. Returns (train pkl, val pkl, bytes on
    disk, filter rows by type)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        videos = list(pool.map(lambda v: write_video(root, v),
                               range(CLI_VIDEOS)))
    rng = np.random.default_rng(11)
    n_flows = len(range(0, CLI_LIST - 8, 2))
    annos = []
    for v, (frames, flows, _, _) in enumerate(videos):
        # the clip start a 121-entry flow timeline allows is 0..57
        chosen = np.sort(rng.choice(58, size=12, replace=False)).tolist()
        annos.append(dict(frames=[frames[i % CLI_FRAME_FILES]
                                  for i in range(CLI_LIST)],
                          enc_flows=[flows[i % CLI_FLOW_FILES]
                                     for i in range(n_flows)],
                          chosen_idx=chosen, label=v % 400))
    paths = []
    for name, part in (('train.pkl', annos * CLI_REPEAT),
                       ('val.pkl', annos[:CLI_VAL_VIDEOS])):
        paths.append(osp.join(root, name))
        with open(paths[-1], 'wb') as f:
            pickle.dump(part, f)
    return (paths[0], paths[1], sum(v[3] for v in videos),
            sum(v[2] for v in videos).tolist())


def cli_run(main, argv):
    """A CLI's main(argv) in this process; returns (its result, kernel
    launches, seconds)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, dict(l_neg=di.l_neg.launches, dq=di.dq.launches), seconds


def pretrain_run(train_pkl, val_pkl, work_dir, epochs, resume_from=None,
                 options=()):
    """The port's training CLI on the flagship config file, in this
    process; returns (runner, launches, seconds)."""
    argv = pretrain_argv(train_pkl, val_pkl, work_dir, epochs, resume_from,
                         options)
    (runner, _), launches, seconds = cli_run(train_cli.main, argv)
    return runner, launches, seconds


def pretrain_argv(train_pkl, val_pkl, work_dir, epochs, resume_from=None,
                  options=()):
    """The training CLI's arguments for the flagship config file over the
    phase's pickles: validation, a checkpoint and a log line every epoch
    and step."""
    argv = [FLAGSHIP_CONFIG, '--validate', '--seed', '0', '--cfg-options',
            f'data.train.pkl_path={train_pkl}',
            f'data.val.pkl_path={val_pkl}', f'total_epochs={epochs}',
            'checkpoint_config.interval=1', 'evaluation.interval=1',
            'log_config.interval=1', f'work_dir={work_dir}', *options]
    if resume_from:
        argv[1:1] = ['--resume-from', resume_from]
    return argv


def steady_window(train, per_epoch, tail):
    """An epoch's first step waits for a batch made from an empty queue
    (cold start) and its second starts while the producer refills the
    queue; its last ``tail`` steps run after the producer has made the
    epoch's last batch (2 queued and 1 in hand), alone. Between them the
    producer decodes beside every step, as through all but the ends of a
    long epoch: the steady window, all its time over all its steps, pooled
    over the epochs. Returns the window's stats."""
    firsts = [r for r in train if r['iter'] == 1]
    steady = [r for r in train if 3 <= r['iter'] <= per_epoch - tail]
    step_s = sum(r['time'] for r in steady) / len(steady)
    wait_s = sum(r['data_time'] for r in steady) / len(steady)
    epochs = sorted({r['epoch'] for r in steady})
    return dict(
        steady_steps=len(steady), steady_iters_per_s=1 / step_s,
        steady_step_s=step_s, steady_data_wait_s=wait_s,
        data_wait_share=wait_s / step_s,
        steady_step_s_by_epoch=[
            sum(r['time'] for r in steady if r['epoch'] == e) /
            sum(1 for r in steady if r['epoch'] == e) for e in epochs],
        cold_batch_wait_s=[r['data_time'] for r in firsts],
        tail_step_s=[r['time'] for r in train
                     if r['iter'] > per_epoch - tail],
        second_step=[dict(time=r['time'], data_time=r['data_time'])
                     for r in train if r['iter'] == 2])


def read_log(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


def states_equal(a, b):
    """Names of what differs between two train_state dicts, bitwise."""
    bad = [k for k, v in a['state_dict'].items()
           if not torch.equal(v, b['state_dict'][k])]
    oa, ob = a['optimizer'], b['optimizer']
    if oa['steps'] != ob['steps']:
        bad.append('steps')
    for i, st in oa['sgd']['state'].items():
        if not torch.equal(st['momentum_buffer'],
                           ob['sgd']['state'][i]['momentum_buffer']):
            bad.append(f'momentum {i}')
    if not torch.equal(a['aug_rng'], b['aug_rng']):
        bad.append('aug_rng')
    return bad


def png_decode_ms(frame):
    """Host ms to decode one of the phase's frames (adaptive filters) with
    the C row unfilter (mean of 20) and with numpy's wavefront (mean of 3),
    and a Sub-only copy with numpy's row pass (mean of 20)."""
    buf = open(frame, 'rb').read()
    img = image_io.decode_png(buf)
    sub = osp.join(osp.dirname(frame), 'sub_only.png')
    write_png(sub, img, kinds=np.ones(len(img), np.int64))
    sub_buf = open(sub, 'rb').read()
    real = image_io._unfilter_lib

    def mean_ms(b, n):
        t0 = time.perf_counter()
        for _ in range(n):
            out = image_io.decode_png(b)
        if not np.array_equal(out, img):
            raise AssertionError('PNG unfilter paths disagree')
        return (time.perf_counter() - t0) / n * 1e3
    c_ms = mean_ms(buf, 20)
    image_io._unfilter_lib = lambda: None
    try:
        numpy_ms, numpy_sub_ms = mean_ms(buf, 3), mean_ms(sub_buf, 20)
    finally:
        image_io._unfilter_lib = real
    return dict(c_ms=c_ms, numpy_wavefront_ms=numpy_ms,
                numpy_sub_only_ms=numpy_sub_ms)


def phase_pretrain_cli(root):
    """The pretrain entry point end to end on the card: the flagship config
    file through ``python -m mscl_torch.tools.train`` (its main()), from
    rawframes on disk (written under root) through the config's own
    pipelines and thread workers, 1 epoch of CLI_REPEAT * 2 steps with
    validation by loss and a checkpoint, then a resume from epoch_1 for a
    second epoch. Returns (launches, the steady window, the pickles, the
    last checkpoint)."""
    t_phase = time.perf_counter()
    timings = dict(save_s=[], state_s=[], resume_s=[])
    real_save, real_state = train_loop.save_checkpoint, \
        train_loop.Runner.state
    real_resume = train_loop.Runner.resume
    resumed = []

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            timings[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def resume(self, path=None):
        timed(real_resume, 'resume_s')(self, path)
        resumed.append(self.state())

    train_loop.save_checkpoint = timed(real_save, 'save_s')
    train_loop.Runner.state = timed(real_state, 'state_s')
    train_loop.Runner.resume = resume
    try:
        t0 = time.perf_counter()
        train_pkl, val_pkl, data_bytes, filter_rows = write_rawframes(root)
        write_s = time.perf_counter() - t0
        decode = png_decode_ms(osp.join(root, 'video_000', 'img_00000.png'))
        work = osp.join(root, 'work')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runner, first, first_s = pretrain_run(train_pkl, val_pkl, work, 1)
        peak = torch.cuda.max_memory_allocated()
        bs, per_epoch = runner.train_loader.batch_size, len(
            runner.train_loader)
        saved = real_state(runner)
        model = runner.model
        state = {f'{t}.{n}': int(getattr(getattr(model, t), n))
                 for t in ('recognizer', 'recognizer_flow')
                 for n in ('queue_ptr', 'iters')}
        del runner, model
        torch.cuda.empty_cache()
        ckpt = osp.join(work, 'epoch_1.pth')
        on_disk = load_checkpoint(ckpt)
        runner, second, second_s = pretrain_run(train_pkl, val_pkl, work, 2,
                                                resume_from=ckpt)
        model = runner.model
        final = {f'{t}.{n}': int(getattr(getattr(model, t), n))
                 for t in ('recognizer', 'recognizer_flow')
                 for n in ('queue_ptr', 'iters')}
        steps = runner.optimizer.steps
        del runner, model
        torch.cuda.empty_cache()
        records = read_log(work)
        files = sorted(os.listdir(work))
        ckpt_bytes = osp.getsize(ckpt)
    finally:
        train_loop.save_checkpoint, train_loop.Runner.state = \
            real_save, real_state
        train_loop.Runner.resume = real_resume

    if per_epoch != CLI_VIDEOS * CLI_REPEAT // bs:
        raise AssertionError(f'{per_epoch} steps an epoch at batch {bs}')
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    for r in records:
        log(phase='pretrain_cli_log', mode=r['mode'], epoch=r['epoch'],
            iter=r.get('iter'), time=r.get('time'),
            data_time=r.get('data_time'), loss=r['loss'])
    bad = [r for r in records
           if not all(math.isfinite(v) for k, v in r.items()
                      if k.startswith('loss'))]
    if bad or len(train) != 2 * per_epoch or len(val) != 2:
        raise AssertionError(f'{len(train)} train and {len(val)} val log '
                             f'lines, non-finite losses in {bad}')
    # a train step launches l_neg and dq 7 times each, a val step l_neg 7
    want_first = want_second = dict(l_neg=7 * per_epoch + 7,
                                    dq=7 * per_epoch)
    if first != want_first or second != want_second:
        raise AssertionError(f'launches {first}, {second}; want '
                             f'{want_first}, {want_second}')
    want, want_final = moco_state(1, per_epoch, bs), \
        moco_state(2, per_epoch, bs)
    if state != want or final != want_final:
        raise AssertionError(f'moco state {state}, {final}; want {want}, '
                             f'{want_final}')
    missing = [n for n in ('epoch_1.pth', 'epoch_2.pth', 'latest')
               if n not in files]
    if missing:
        raise AssertionError(f'missing {missing} in {files}')
    diff = states_equal(saved, on_disk) + states_equal(saved, resumed[0])
    if diff or len(resumed) != 1:
        raise AssertionError(f'the state loaded at resume differs from the '
                             f'state saved: {diff[:10]}')
    if resumed[0]['optimizer']['steps'] != per_epoch or \
            steps != 2 * per_epoch:
        raise AssertionError(f'resumed at step '
                             f'{resumed[0]["optimizer"]["steps"]}, ended at '
                             f'{steps}')
    window = steady_window(train, per_epoch, CLI_TAIL)
    launches = dict(l_neg=first['l_neg'] + second['l_neg'],
                    dq=first['dq'] + second['dq'])
    log(phase='png_decode', frame_hw=CLI_FRAME_HW,
        filter_rows=dict(zip(('none', 'sub', 'up', 'avg', 'paeth'),
                             filter_rows)), **decode)
    log(phase='pretrain_cli', config=osp.relpath(FLAGSHIP_CONFIG),
        videos=CLI_VIDEOS, train_entries=CLI_VIDEOS * CLI_REPEAT,
        val_videos=CLI_VAL_VIDEOS, batch=bs, steps_per_epoch=per_epoch,
        workers=load_flagship_config().data['workers_per_gpu'],
        workers_mode='thread', data_bytes=data_bytes, data_write_s=write_s,
        train_steps=len(train), val_steps=len(val), **window,
        peak_bytes=peak, checkpoint_bytes=ckpt_bytes,
        state_copy_s=timings['state_s'], save_s=timings['save_s'],
        resume_load_s=timings['resume_s'], run_s=[first_s, second_s],
        launches=launches, state=final, resumed_at_step=per_epoch,
        losses=[r['loss'] for r in train],
        phase_s=time.perf_counter() - t_phase)
    return launches, window, (train_pkl, val_pkl), \
        osp.join(work, 'epoch_2.pth')


def moco_state(epochs, per_epoch, bs):
    n = epochs * per_epoch * bs         # clips trained on
    return {'recognizer.queue_ptr': n % K, 'recognizer_flow.queue_ptr':
            n % K, 'recognizer.iters': n, 'recognizer_flow.iters': 2 * n}


def batch_transport(dataset, bs):
    """What one batch of the process workers costs to move: the bytes of
    the pickle a worker puts on the result queue (its samples, as
    multiprocessing pickles them) and the parent's time to unpickle it
    (mean of 3)."""
    from multiprocessing.reduction import ForkingPickler
    samples = [dataset[i] for i in range(bs)]
    blob = bytes(ForkingPickler.dumps((1, 0, samples)))
    t0 = time.perf_counter()
    for _ in range(3):
        pickle.loads(blob)
    return dict(batch_pickle_bytes=len(blob),
                batch_unpickle_s=(time.perf_counter() - t0) / 3)


def phase_pretrain_cli_process(root, pkls, thread_window):
    """pretrain_cli's config and data with the decode workers as processes
    (``data.workers_mode=process``): 1 epoch with validation; its steady
    window beside thread mode's, what a batch moves through the result
    queue, and no decode process left after the run."""
    import multiprocessing
    from mscl_torch.datasets import loader as t_loader
    t_phase = time.perf_counter()
    work = osp.join(root, 'work_process')
    train_pkl, val_pkl = pkls
    # each read of a batch's bytes from the result pipe in the parent's
    # producer thread, live: its seconds and bytes
    reads, real_init = [], t_loader._ProcessPool.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        recv = self.result_q._recv_bytes

        def timed_recv(*a):
            t0 = time.perf_counter()
            buf = recv(*a)
            reads.append((time.perf_counter() - t0, len(buf)))
            return buf
        self.result_q._recv_bytes = timed_recv

    t_loader._ProcessPool.__init__ = init
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runner, launches, run_s = pretrain_run(
            train_pkl, val_pkl, work, 1,
            options=['data.workers_mode=process'])
        peak = torch.cuda.max_memory_allocated()
    finally:
        t_loader._ProcessPool.__init__ = real_init
    loader = runner.train_loader
    # the decode processes, every child but the script's reference workers
    children = [p for p in multiprocessing.active_children()
                if not any(p.pid in pool._processes for pool in _WORKERS)]
    if loader.workers_mode != 'process' or loader._pool is not None or \
            children:
        raise AssertionError(f'mode {loader.workers_mode}, pool '
                             f'{loader._pool}, children {children}')
    bs = loader.batch_size
    per_epoch = len(loader)
    state = {f'{t}.{n}': int(getattr(getattr(runner.model, t), n))
             for t in ('recognizer', 'recognizer_flow')
             for n in ('queue_ptr', 'iters')}
    transport = batch_transport(loader.dataset, bs)
    del runner, loader
    torch.cuda.empty_cache()
    records = read_log(work)
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    bad = [r for r in records
           if not all(math.isfinite(v) for k, v in r.items()
                      if k.startswith('loss'))]
    if bad or len(train) != per_epoch or len(val) != 1:
        raise AssertionError(f'{len(train)} train and {len(val)} val log '
                             f'lines, non-finite losses in {bad}')
    want = dict(l_neg=7 * per_epoch + 7, dq=7 * per_epoch)
    if launches != want or state != moco_state(1, per_epoch, bs):
        raise AssertionError(f'launches {launches}, state {state}')
    window = steady_window(train, per_epoch, CLI_TAIL)
    log(phase='pretrain_cli_process', workers_mode='process',
        workers=load_flagship_config().data['workers_per_gpu'], batch=bs,
        steps_per_epoch=per_epoch, train_steps=len(train), **window,
        steady_step_ratio_to_thread=(window['steady_step_s'] /
                                     thread_window['steady_step_s']),
        **transport, live_reads=len(reads),
        live_read_bytes=[n for _, n in reads],
        live_read_s=[t for t, _ in reads], peak_bytes=peak, run_s=run_s,
        launches=launches,
        state=state, losses=[r['loss'] for r in train],
        phase_s=time.perf_counter() - t_phase)
    return launches


def dp_global_batch(train_pkl, path):
    """One global batch of DP_BATCH clips of pretrain_cli's set through the
    flagship config's train pipeline (host draws from seed 0), pickled to
    path for the ranks."""
    from mscl_torch.datasets import build_dataset
    from mscl_torch.datasets.loader import default_collate
    cfg = load_flagship_config()
    cfg.merge_from_dict({'data.train.pkl_path': train_pkl})
    dataset = build_dataset(cfg.data['train'].to_dict())
    random.seed(0)
    np.random.seed(0)
    batch = default_collate([dataset[i] for i in range(DP_BATCH)])
    with open(path, 'wb') as f:
        pickle.dump(batch, f)


def dp_rows(tree):
    """This rank's rows of a numpy global batch (the whole with no
    group)."""
    if isinstance(tree, dict):
        return {k: dp_rows(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [dp_rows(v) for v in tree]
    per = tree.shape[0] // dist.world_size()
    return tree[dist.rank() * per:(dist.rank() + 1) * per]


def state_digest(state):
    """sha256 over a state dict's names and bytes, in order."""
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def dp_compare(state, logs, ref_state, ref_logs):
    """A state and the logged values against world 1's, by what the
    tolerances name: every loss key, the queues (count, queue_ptr and
    iters exact), the EMA key towers, the BN statistics and the query side
    after SGD. Returns the largest abs error of each group, its largest
    share of the tolerance (a miss above 1, or NaN), and the misses as
    (share, name) by group."""
    groups = dict(
        queues=lambda k: k.endswith('.queue'),
        bn_stats=lambda k: 'running' in k,
        ema=lambda k: any(f'.{p}.' in k for p in MOCO_FREEZE),
        params=lambda k: '_q.' in k or k.startswith('sup_head.'))
    errs = {g: 0.0 for g in DP_TOL}
    shares = {g: 0.0 for g in DP_TOL}
    misses = {g: [] for g in list(DP_TOL) + ['exact']}

    def check(group, name, got, want):
        rtol, atol = DP_TOL[group]
        got, want = torch.as_tensor(got).double(), \
            torch.as_tensor(want).double()
        diff = (got - want).abs()
        share = float((diff / (atol + rtol * want.abs())).max())
        errs[group] = max(errs[group], float(diff.max()))
        shares[group] = max(shares[group], share)
        if not share <= 1:            # NaN too
            misses[group].append((share, name))

    for k in (k for k in ref_logs if 'loss' in k):
        check('losses', k, logs[k], ref_logs[k])
    for k, want in ref_state.items():
        got = state[k]
        if not want.is_floating_point():
            if not torch.equal(got, want):
                misses['exact'].append((math.inf, k))
            continue
        group = next((g for g, sel in groups.items() if sel(k)), None)
        if group is None:
            misses['exact'].append((math.inf, f'no tolerance for {k}'))
        else:
            check(group, k, got, want)
    return errs, shares, misses


def dp_model_cfg(width):
    """The flagship config's model ('full'), or its recipe narrowed
    (DP_NARROW) with the config's aug."""
    cfg = load_flagship_config()
    if width == 'full':
        return cfg.model.to_dict()
    return narrow_flagship_cfg(**DP_NARROW, aug=cfg.model.aug.to_dict())


def dp_bn_layer():
    """One train-mode BatchNorm3d at r3d_18's stem shape for the global
    batch (DP_BATCH, 64, 8, 56, 56), this rank's rows of seeded inputs
    (all of them with no group), against float64 over the global batch:
    the largest error of y, dx, dweight, dbias and the running statistics,
    each relative to the largest entry of its float64 value."""
    from mscl_torch.ops.batch_norm import BatchNorm3d
    dev = torch.device('cuda', torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (DP_BATCH, 64, 8, 56, 56)
    x = torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.3
    dy = torch.randn(shape, generator=gen, device=dev)
    bn = BatchNorm3d(64).to(dev).train()
    xr = dist.rank_rows(x).clone().requires_grad_(True)
    y = bn(xr)
    (y * dist.rank_rows(dy)).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    dist.all_reduce_(grads, tag='check')
    got = [dist.all_gather_rows(y.detach(), tag='check'),
           dist.all_gather_rows(xr.grad, tag='check'), *grads,
           bn.running_mean, bn.running_var]
    x64 = x.double().requires_grad_(True)
    y64 = F.batch_norm(x64, None, None, None, None, True, 0.0, 1e-5)
    (y64 * dy.double()).sum().backward()
    axes = (0, 2, 3, 4)
    want = [y64.detach(), x64.grad, (dy.double() * y64.detach()).sum(axes),
            dy.double().sum(axes), 0.1 * x.double().mean(axes),
            0.9 + 0.1 * x.double().var(axes, unbiased=False)]
    names = ('y', 'dx', 'dweight', 'dbias', 'running_mean', 'running_var')
    return {n: float((a.double() - b).abs().max() / b.abs().max())
            for n, a, b in zip(names, got, want)}


def dp_steps(batch_path, ref_path=None, width='full', img_scale=None):
    """DP_STEPS train steps of the flagship config (its model at full
    width, K=65536, V5, float32, TF32 off; or narrowed) on this rank's
    rows of the global batch, or the whole with no process group (the
    images times img_scale, if given). Returns the steps' seconds, logged
    values, launches, collectives, peak memory, a digest of the final
    state; with ref_path (world 1's run) each step's errors against it,
    else each step's state (on the host)."""
    dev = torch.device('cuda', torch.cuda.current_device())
    bn_layer = dp_bn_layer() if width == 'full' else None
    torch.cuda.empty_cache()
    cfg = load_flagship_config()
    model = build_model_from_cfg(dp_model_cfg(width), device=dev, seed=0)
    lr = build_lr_schedule(cfg.lr_config.to_dict(), cfg.optimizer['lr'],
                           cfg.total_epochs, cfg.dataset_size // DP_BATCH)
    opt = build_optimizer(model, cfg.optimizer.to_dict(), lr,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    with open(batch_path, 'rb') as f:
        batch = dp_rows(pickle.load(f))
    if img_scale is not None:
        batch['imgs'] = [x * np.float32(img_scale) for x in batch['imgs']]
    batch = to_torch(batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    dist.reset_counts()
    step_s, logs, states, collectives = [], [], [], []
    for _ in range(DP_STEPS):
        dist.reset_counts()
        t0 = time.perf_counter()
        log_vars = step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        collectives.append(dist.counts())
        logs.append({k: v.item() for k, v in log_vars.items()})
        states.append({k: v.detach().to('cpu', copy=True)
                       for k, v in model.state_dict().items()})
    out = dict(rank=dist.rank(), world=dist.world_size(),
               backend=dist.backend(), rows=batch['imgs'][0].shape[0],
               width=width, step_s=step_s, logs=logs,
               launches=dict(l_neg=di.l_neg.launches, dq=di.dq.launches),
               collectives=collectives,
               peak_bytes=torch.cuda.max_memory_allocated(),
               digest=state_digest(states[-1]), bn_layer=bn_layer)
    if ref_path is None:
        out['states'] = states
    else:
        ref = torch.load(ref_path, weights_only=True)
        out['compare'] = [dp_compare(st, lv, rs, rl) for st, lv, rs, rl in
                          zip(states, logs, ref['states'], ref['logs'])]
    return out


def dp_steps_both(batch_path, ref_path, narrow_path):
    """``dp_steps`` at full width against ``ref_path``, then narrowed
    against ``narrow_path``, in one rank: the world-2 paths share one
    spawn."""
    return (dp_steps(batch_path, ref_path),
            dp_steps(batch_path, narrow_path, 'narrow'))


def dp_cli_rank(argv):
    """The training CLI's work on this rank (``tools.train._train``, what
    its launcher runs on each rank), instrumented: the records it logs,
    the files it opens for writing (torch.save included), whether the
    state a resume loaded equals the file's bitwise, the launches, the
    final queue pointers, iters and steps, peak memory: every rank's, in
    rank order."""
    import mscl_torch.core.train_loop as tl
    real_open, real_save = builtins.open, torch.save
    real_log, real_resume, real_run = tl.Runner.log, tl.Runner.resume, \
        tl.Runner.run
    records, writes, resumed, runners = [], [], [], []

    def tracing_open(file, mode='r', *args, **kwargs):
        if any(c in mode for c in 'wax+'):
            writes.append(osp.basename(str(file)))
        return real_open(file, mode, *args, **kwargs)

    def tracing_save(obj, f, *args, **kwargs):
        writes.append(osp.basename(str(f)))
        return real_save(obj, f, *args, **kwargs)

    def log_(self, record):
        records.append(dict(record))
        real_log(self, record)

    def resume(self, path=None):
        real_resume(self, path)
        want, got = load_checkpoint(path), self.state()
        resumed.append(states_equal(want, got))

    def run_(self):
        runners.append(self)
        real_run(self)

    tl.Runner.log, tl.Runner.resume, tl.Runner.run = log_, resume, run_
    builtins.open, torch.save = tracing_open, tracing_save
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        train_cli._train(train_cli.parse_args(argv))
    finally:
        builtins.open, torch.save = real_open, real_save
        tl.Runner.log, tl.Runner.resume, tl.Runner.run = real_log, \
            real_resume, real_run
    runner = runners[0]
    model = runner.model
    out = dict(
        rank=dist.rank(), backend=dist.backend(), records=records,
        writes=writes, resumed=resumed,
        launches=dict(l_neg=di.l_neg.launches, dq=di.dq.launches),
        state={f'{t}.{n}': int(getattr(getattr(model, t), n))
               for t in ('recognizer', 'recognizer_flow')
               for n in ('queue_ptr', 'iters')},
        steps=runner.optimizer.steps, batch=runner.train_loader.batch_size,
        per_epoch=len(runner.train_loader),
        peak_bytes=torch.cuda.max_memory_allocated())
    every = [None] * dist.world_size()
    torch.distributed.all_gather_object(every, out)
    return every


def dp_world2(batch_path, ref_path, narrow_path, argvs):
    """This rank's work at world 2, in one launch of the ranks (a launch
    costs each rank its start, its imports and its card): ``dp_steps_both``
    (every rank's results gathered, and the seconds they took), then
    ``dp_cli_rank`` of each argv in turn, the CLI's run and its resume."""
    t0 = time.perf_counter()
    steps = dp_steps_both(batch_path, ref_path, narrow_path)
    every = [None] * dist.world_size()
    torch.distributed.all_gather_object(every, steps)
    return every, time.perf_counter() - t0, \
        [dp_cli_rank(argv) for argv in argvs]


def dp_step_line(path, runs, ref_s, floor=None, gate=True):
    """Log a path's numbers: step times, the last step's collectives
    (calls, bytes, host seconds inside them; rank 0's), launches and peak
    memory a rank, and each step's errors against world 1's by group
    with their share of the tolerance. Fails (with gate) on a miss of any
    rank, on ranks whose states differ, or on launches other than 7 + 7 a
    step. In the groups that are ill-conditioned after the second step at
    full width a miss is a share of the tolerance above 1 and above
    DP_ULP_MULT times floor's (the ulp controls' larger share, by step
    and group)."""
    per_step = runs[0]['collectives'][-1]
    held, logged = [], []
    for r in runs:
        for i, (_, _, misses) in enumerate(r['compare']):
            loose = r['width'] == 'full' and i > 0
            for group, found in misses.items():
                limit = max(1.0, DP_ULP_MULT * floor[i][group]) \
                    if loose and floor and group in DP_ILL_CONDITIONED \
                    else 1.0
                for share, name in found:
                    out = held if not share <= limit else logged
                    out.append(f'rank {r["rank"]} step {i + 1} {name} '
                               f'({share:.3g}x, limit {limit:.3g}x)')
    log(phase='pretrain_dp_step', path=path, width=runs[0]['width'],
        world=runs[0]['world'], backend=runs[0]['backend'],
        rows_a_rank=runs[0]['rows'], step_s=[r['step_s'] for r in runs],
        step_ratio_to_no_group=[r['step_s'][-1] / ref_s for r in runs],
        collectives_a_step=per_step,
        launches_a_rank=[r['launches'] for r in runs],
        peak_bytes=[r['peak_bytes'] for r in runs],
        max_abs_err=[{g: max(r['compare'][i][0][g] for r in runs)
                      for g in DP_TOL} for i in range(DP_STEPS)],
        tolerance_share=[{g: max(r['compare'][i][1][g] for r in runs)
                          for g in DP_TOL} for i in range(DP_STEPS)],
        share_limit=[{g: DP_ULP_MULT * floor[i][g] for g in
                      DP_ILL_CONDITIONED} if floor and i > 0 else None
                     for i in range(DP_STEPS)],
        bn_layer_vs_float64=[r['bn_layer'] for r in runs],
        misses_held=held[:10], misses_within_limit=len(logged),
        losses=[{k: v for k, v in lv.items() if 'loss' in k}
                for lv in runs[0]['logs']])
    held += [f'rank {r["rank"]} BN layer {k} {v:.3g} of float64'
             for r in runs if r['bn_layer']
             for k, v in r['bn_layer'].items() if not v <= F64_REL]
    digests = {r['digest'] for r in runs}
    want = dict(l_neg=7 * DP_STEPS, dq=7 * DP_STEPS)
    bad = [r['launches'] for r in runs if r['launches'] != want]
    if gate and (held or len(digests) != 1 or bad):
        raise AssertionError(f'{path}: {len(held)} misses ({held[:5]}), '
                             f'{len(digests)} states over the ranks, '
                             f'launches {bad} (want {want} a rank)')
    return per_step


def dp_reference(batch_path, path, width):
    """World 1 with no process group: its steps saved to path for the
    ranks; returns its run."""
    ref = dp_steps(batch_path, width=width)
    torch.save(dict(states=ref.pop('states'), logs=ref['logs']), path)
    torch.cuda.empty_cache()
    bad_bn = {k: v for k, v in (ref['bn_layer'] or {}).items()
              if v > F64_REL}
    if ref['launches'] != dict(l_neg=7 * DP_STEPS, dq=7 * DP_STEPS) or \
            any(ref['collectives']) or bad_bn:
        raise AssertionError(f'world 1: launches {ref["launches"]}, '
                             f'collectives {ref["collectives"]}, BN layer '
                             f'{bad_bn} of float64')
    log(phase='pretrain_dp_step', path='no_group', width=width, world=1,
        backend=None, rows_a_rank=ref['rows'], step_s=[ref['step_s']],
        launches_a_rank=[ref['launches']], peak_bytes=[ref['peak_bytes']],
        bn_layer_vs_float64=[ref['bn_layer']],
        losses=[{k: v for k, v in lv.items() if 'loss' in k}
                for lv in ref['logs']])
    return ref


def phase_pretrain_dp(root, pkls):
    """Data parallelism on the card: (a) DP_STEPS flagship steps on one
    global batch at world 2 (two gloo ranks sharing the card, each its 16
    rows) against world 1 with no process group, within DP_TOL, and where
    the second step is ill-conditioned within DP_ULP_MULT times the ulp
    controls (world 1 with its images one ulp smaller and larger;
    ``dp_step_line``), and at the narrow width within DP_TOL for both
    steps (in the same two ranks, after the full-width steps); every
    rank's state the same bitwise; (c) the full-width steps at world 1
    under NCCL, the launcher's path (its rank spawned beside the controls
    and the two gloo ranks: its start overlaps theirs); (b) in the same
    launch of the two ranks as (a), the launcher's (``--num-devices 2``:
    two gloo ranks on the card), the training CLI (a global batch of 32)
    for 1 epoch of DP_CLI_STEPS steps, then a resume to a second: one loss
    on both ranks every step, files from rank 0 only, the state loaded at
    resume equal to the state saved, bitwise, on both ranks."""
    t_phase = time.perf_counter()
    train_pkl, val_pkl = pkls
    batch_path = osp.join(root, 'dp_batch.pkl')
    ref_path = osp.join(root, 'dp_world1.pth')
    dp_global_batch(train_pkl, batch_path)
    ref_s = dp_reference(batch_path, ref_path, 'full')['step_s'][-1]

    def nccl_world1():
        t0 = time.perf_counter()
        runs = dist.spawn(dp_steps, 1, (batch_path, ref_path),
                          backend='nccl', device='cuda', join_timeout_s=600)
        return runs, time.perf_counter() - t0
    from concurrent.futures import ThreadPoolExecutor
    side = ThreadPoolExecutor(1)
    nccl_run = side.submit(nccl_world1)
    # the step's own conditioning: world 1 again, the images one ulp
    # smaller (times 1 - 2^-24) and one ulp larger (times 1 + 2^-23)
    controls = []
    for name, scale in (('no_group_ulp', 1 - 2 ** -24),
                        ('no_group_ulp_up', 1 + 2 ** -23)):
        controls.append(dp_steps(batch_path, ref_path, img_scale=scale))
        dp_step_line(name, controls[-1:], ref_s, gate=False)
        torch.cuda.empty_cache()
    floor = [{g: max(c['compare'][i][1][g] for c in controls)
              for g in DP_TOL} for i in range(DP_STEPS)]
    narrow_path = osp.join(root, 'dp_world1_narrow.pth')
    narrow_s = dp_reference(batch_path, narrow_path, 'narrow')['step_s'][-1]
    t0 = time.perf_counter()
    work = osp.join(root, 'work_dp')
    opts = [f'data.videos_per_gpu={DP_CLI_ROWS}']
    cli_pkl = osp.join(root, 'dp_cli_train.pkl')
    with open(train_pkl, 'rb') as f:
        annos = pickle.load(f)
    with open(cli_pkl, 'wb') as f:
        pickle.dump(annos[:DP_CLI_STEPS * DP_BATCH], f)
    argvs = [pretrain_argv(cli_pkl, val_pkl, work, epochs, resume,
                           options=opts) + ['--num-devices', '2']
             for epochs, resume in ((1, None),
                                    (2, osp.join(work, 'epoch_1.pth')))]
    # the launcher's two gloo ranks (two ranks share the card): the steps
    # against world 1, then the CLI; local rank 0's values, every rank's
    # gathered in rank order
    both, gloo_s, (first, second) = launch.run(
        dp_world2, train_cli.parse_args(argvs[0]),
        batch_path, ref_path, narrow_path, argvs)
    cli_s = time.perf_counter() - t0 - gloo_s
    with side:
        nccl, nccl_s = nccl_run.result()
    dp_step_line('nccl_world1', nccl, ref_s, floor)
    collectives = dp_step_line('gloo_world2', [b[0] for b in both], ref_s,
                               floor)
    dp_step_line('gloo_world2', [b[1] for b in both], narrow_s)
    per_epoch, bs = first[0]['per_epoch'], first[0]['batch']
    if (per_epoch, bs) != (DP_CLI_STEPS, DP_BATCH):
        raise AssertionError(f'{per_epoch} steps an epoch of {bs}')
    problems = []
    for run, epochs, runs in ((1, 1, first), (2, 2, second)):
        losses = [[(r['mode'], r['epoch'], r.get('iter'), r['loss'])
                   for r in res['records']] for res in runs]
        if losses[0] != losses[1]:
            problems.append(f'run {run}: the ranks logged other losses')
        if not all(math.isfinite(x[-1]) for x in losses[0]):
            problems.append(f'run {run}: a non-finite loss')
        if runs[1]['writes'] or not runs[0]['writes']:
            problems.append(f'run {run}: writes {runs[0]["writes"]}, '
                            f'{runs[1]["writes"]}')
        steps = epochs * per_epoch
        want_state = moco_state(epochs, per_epoch, bs)
        # an epoch's train steps and its one val step, 7 l_neg each
        want_launches = dict(l_neg=7 * per_epoch + 7, dq=7 * per_epoch)
        for res in runs:
            if res['state'] != want_state or res['steps'] != steps or \
                    res['launches'] != want_launches or \
                    res['backend'] != 'gloo':
                problems.append(f'run {run} rank {res["rank"]}: state '
                                f'{res["state"]}, steps {res["steps"]}, '
                                f'launches {res["launches"]}, backend '
                                f'{res["backend"]}')
    if any(res['resumed'] != [[]] for res in second):
        problems.append(f'resume: {[res["resumed"] for res in second]}')
    with open(osp.join(work, 'log.json')) as f:
        lines = f.read().splitlines()
    want_lines = len(first[0]['records']) + len(second[0]['records'])
    if len(lines) != want_lines:
        problems.append(f'log.json has {len(lines)} lines, rank 0 logged '
                        f'{want_lines}')
    if problems:
        raise AssertionError(f'pretrain_dp CLI: {problems[:10]}')
    train = [r for r in first[0]['records'] + second[0]['records']
             if r['mode'] == 'train']
    window = steady_window(train, per_epoch, DP_CLI_TAIL)
    log(phase='pretrain_dp_cli', world=2, backend='gloo',
        rows_a_rank=DP_CLI_ROWS, batch=bs, steps_per_epoch=per_epoch,
        train_steps=len(train), steady_step_s=window['steady_step_s'],
        steady_data_wait_s=window['steady_data_wait_s'],
        tail_step_s=window['tail_step_s'],
        launches_a_rank=[[r['launches'] for r in runs]
                         for runs in (first, second)],
        peak_bytes=[[r['peak_bytes'] for r in runs]
                    for runs in (first, second)],
        rank0_writes=sorted(set(first[0]['writes'] + second[0]['writes'])),
        resumed_bitwise=True, losses=[r['loss'] for r in train])
    log(phase='pretrain_dp', seconds=dict(
        gloo_world2=gloo_s, nccl_world1=nccl_s, cli=cli_s,
        phase=time.perf_counter() - t_phase),
        collectives_a_step=collectives)


def write_ssv2_frames(root):
    """FT_VIDEOS SSv2-shaped videos (FT_FRAMES PNG frames of FT_FRAME_HW,
    written by 8 threads, label v % FT_CLASSES); a train pickle listing
    them FT_REPEAT times and a val pickle of the first FT_VAL_VIDEOS.
    Returns (train pkl, val pkl, bytes on disk)."""
    from concurrent.futures import ThreadPoolExecutor
    root = osp.join(root, 'ssv2')
    os.makedirs(root)
    with ThreadPoolExecutor(8) as pool:
        videos = list(pool.map(lambda v: write_video(
            root, v, FT_FRAME_HW, FT_FRAMES, 0), range(FT_VIDEOS)))
    annos = [dict(frames=frames, label=v % FT_CLASSES)
             for v, (frames, _, _, _) in enumerate(videos)]
    paths = []
    for name, part in (('train.pkl', annos * FT_REPEAT),
                       ('val.pkl', annos[:FT_VAL_VIDEOS])):
        paths.append(osp.join(root, name))
        with open(paths[-1], 'wb') as f:
            pickle.dump(part, f)
    return paths[0], paths[1], sum(v[3] for v in videos)


def finetune_options(train_pkl, val_pkl, work):
    """--cfg-options of the fine-tune phases: the pickles, the work dir
    (the val and test sets' per-class files too), a checkpoint, validation
    and a log line every epoch and step, and the step policy's milestone
    at epoch 1 (the config's 14 and 18 of 22 epochs, cut to 2)."""
    return [f'data.train.pkl_path={train_pkl}',
            f'data.val.pkl_path={val_pkl}', f'data.test.pkl_path={val_pkl}',
            f'data.val.visual_cfg.cur_path={work}',
            f'data.test.visual_cfg.cur_path={work}', f'work_dir={work}',
            'total_epochs=2', 'lr_config.step=[1]', 'evaluation.interval=1',
            'checkpoint_config.interval=1', 'log_config.interval=1']


def phase_finetune_cli(root, pretrain_ckpt):
    """README workload 2 on the card: test_ssv2_r18.py at full width
    (r3d_18 64 wide, I3DHead for 174 classes, dropout 0.5, batch 32, SGD lr
    0.12 under the step policy) through ``python -m mscl_torch.tools.train
    --validate`` over an SSv2-shaped PNG set, its backbone from the
    pretrain phase's checkpoint: 2 epochs of FT_STEPS steps with
    validation by metrics after each; then one step profiled. Fails unless
    the backbone equals the checkpoint's encoder_q bitwise before step 1,
    each logged lr is the step policy's and every val line has top1, top5
    and mean-class accuracy. Returns (pickles, work dir, the log line)."""
    from mscl_torch.apis import train as train_api
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    train_pkl, val_pkl, data_bytes = write_ssv2_frames(root)
    write_s = time.perf_counter() - t0
    work = osp.join(root, 'finetune')
    options = finetune_options(train_pkl, val_pkl, work) + [
        f'model.train_cfg.ssl_pretrain.pretrained.filename={pretrain_ckpt}']
    encoder = {k[len('recognizer.encoder_q.'):]: v for k, v in
               load_checkpoint(pretrain_ckpt)['state_dict'].items()
               if k.startswith('recognizer.encoder_q.')}
    grafted = []
    real = train_api.apply_ssl_pretrain

    def apply_and_check(model, ssl_cfg):
        real(model, ssl_cfg)
        got = {k[len('backbone.'):]: v.cpu() for k, v in
               model.state_dict().items() if k.startswith('backbone.')}
        grafted.append(sorted(got) == sorted(encoder) and all(
            torch.equal(got[k], v) for k, v in encoder.items()))

    train_api.apply_ssl_pretrain = apply_and_check
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (runner, model), launches, run_s = cli_run(
            train_cli.main, [FT_CONFIG, '--validate', '--seed', '0',
                             '--cfg-options', *options])
        peak = torch.cuda.max_memory_allocated()
    finally:
        train_api.apply_ssl_pretrain = real
    if grafted != [True]:
        raise AssertionError(f'the backbone is not the pretrain encoder_q '
                             f'({grafted})')
    fc = model.cls_head.fc_cls
    if (fc.in_features, fc.out_features) != (FT_FEATURES, FT_CLASSES) or \
            model.backbone.layer4[-1].conv2[0].out_channels != FT_FEATURES \
            or model.cls_head.dropout_ratio != 0.5:
        raise AssertionError(f'not the config\'s model: {model}')
    if launches != dict(l_neg=0, dq=0):
        raise AssertionError(f'decayed InfoNCE launched: {launches}')
    it = iter(runner.train_loader)
    batch = to_torch(next(it), 'cuda')
    it.close()
    it._thread.join()               # no decode thread beside the step
    profile('finetune_step', lambda: runner._train_step(batch))
    per_epoch = len(runner.train_loader)
    bs = runner.train_loader.batch_size
    dropout_state = runner.model.dropout_state()
    del runner, model, batch
    torch.cuda.empty_cache()
    records = read_log(work)
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val' and 'best_score' not in r]
    cfg = Config.fromfile(FT_CONFIG)
    base_lr = cfg.optimizer['lr']
    bad = [r for r in train if not math.isfinite(r['loss']) or not
           math.isclose(r['lr'], base_lr * 0.1 ** (
               ((r['epoch'] - 1) * per_epoch + r['iter']) // per_epoch >= 1),
               rel_tol=1e-12)]
    if bad or len(train) != 2 * per_epoch or len(val) != 2 or \
            dropout_state is None:
        raise AssertionError(f'{len(train)} train and {len(val)} val lines; '
                             f'lr or loss off in {bad}')
    if not all({'top1_acc', 'top5_acc', 'mean_class_accuracy'} <= set(r)
               for r in val):
        raise AssertionError(f'val lines without the metrics: {val}')
    files = sorted(os.listdir(work))
    if not {'epoch_1.pth', 'epoch_2.pth', 'latest'} <= set(files):
        raise AssertionError(f'checkpoints missing in {files}')
    window = steady_window(train, per_epoch, CLI_TAIL)
    log(phase='finetune_cli', config=FT_CONFIG, videos=FT_VIDEOS,
        train_entries=FT_VIDEOS * FT_REPEAT, val_videos=FT_VAL_VIDEOS,
        frame_hw=FT_FRAME_HW, frames=FT_FRAMES, classes=FT_CLASSES,
        batch=bs, steps_per_epoch=per_epoch,
        workers=cfg.data['workers_per_gpu'], data_bytes=data_bytes,
        data_write_s=write_s, surgery_bitwise=True, **window,
        lr=[r['lr'] for r in train], losses=[r['loss'] for r in train],
        val=[{k: r[k] for k in ('top1_acc', 'top5_acc',
                                'mean_class_accuracy')} for r in val],
        peak_bytes=peak, checkpoint_bytes=osp.getsize(
            osp.join(work, 'epoch_2.pth')), run_s=run_s,
        phase_s=time.perf_counter() - t_phase)
    return (train_pkl, val_pkl), work


def timed_calls(module, name):
    """Patch ``module.name`` to add each call's seconds to the returned
    list; returns (list, a function that restores it)."""
    real, spent = getattr(module, name), []

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapper)
    return spent, lambda: setattr(module, name, real)


def phase_test_cli(pkls, work):
    """README workload 2's test: ``python -m mscl_torch.tools.test`` on the
    fine-tuned checkpoint over the test set (the val videos, 8 clips at
    128x128 each): its metrics, and videos/s over the CLI's whole run and
    over its loop of decode and forward (``run_test``) alone."""
    from mscl_torch.apis import inference
    out = osp.join(work, 'test.json')
    argv = [FT_CONFIG, osp.join(work, 'epoch_2.pth'), '--out', out,
            '--cfg-options', *finetune_options(*pkls, work)]
    loop_s, restore = timed_calls(inference, 'run_test')
    try:
        metrics, launches, seconds = cli_run(test_cli.main, argv)
    finally:
        restore()
    with open(out) as f:
        written = json.load(f)
    if written != metrics or sorted(metrics) != [
            'mean_class_accuracy', 'top1_acc', 'top5_acc'] or \
            not all(0 <= v <= 1 for v in metrics.values()) or \
            any(launches.values()):
        raise AssertionError(f'test metrics {metrics}, written {written}')
    log(phase='test_cli', videos=FT_VAL_VIDEOS, metrics=metrics,
        run_s=seconds, videos_per_s=FT_VAL_VIDEOS / seconds,
        loop_s=loop_s, loop_videos_per_s=FT_VAL_VIDEOS / sum(loop_s),
        launches=launches)


def phase_retrieval_cli(root, pkls, pretrain_ckpt):
    """README workload 3: ``python -m mscl_torch.tools.test_retrieval
    --ssl`` with the pretrain checkpoint's encoder (train split: the
    fine-tune train list through the train pipeline, test split: the val
    videos), then with train = test (the config dumped with data.train set
    to data.test), where every video retrieves itself: recall@1 = 1."""
    work = osp.join(root, 'retrieval')
    options = finetune_options(*pkls, work) + [
        f'model.train_cfg.ssl_pretrain.pretrained.filename={pretrain_ckpt}']
    cfg = Config.fromfile(FT_CONFIG)
    cfg.merge_from_dict(dict(o.split('=', 1) for o in options[:3]))
    cfg.merge_from_dict({'data.train': cfg.data.test.to_dict()})
    same = osp.join(root, 'retrieval_same.py')
    cfg.dump(same)
    runs = (('config', FT_CONFIG, options,
             FT_VIDEOS * FT_REPEAT + FT_VAL_VIDEOS),
            ('train_is_test', same, options[1:], 2 * FT_VAL_VIDEOS))
    from mscl_torch.apis import inference
    out = {}
    for name, config, opts, n in runs:
        loop_s, restore = timed_calls(inference, 'extract_features')
        try:
            metrics, launches, seconds = cli_run(
                retrieval_cli.main, [config, '--ssl', '--cfg-options', *opts])
        finally:
            restore()
        out[name] = dict(metrics=metrics, run_s=seconds, features=n,
                         features_per_s=n / seconds, loop_s=loop_s,
                         loop_features_per_s=n / sum(loop_s),
                         launches=launches)
    if out['train_is_test']['metrics']['recall@1'] != 1.0 or not all(
            0 <= v <= 1 for v in out['config']['metrics'].values()) or \
            any(any(o['launches'].values()) for o in out.values()):
        raise AssertionError(f'retrieval {out}')
    log(phase='retrieval_cli', **out)


def jpeg_decoder_check(root):
    """Every committed JPEG fixture through the C decoder at reduce 1 and
    2, held bitwise against the digests of cv2's decode (written by
    tests/_torch_jpeg_util.py; this machine has no cv2); then the host ms
    to decode one 256x340 frame at each reduce, and the same image as PNG
    (the C row unfilter, libpng's adaptive filters)."""
    with open(osp.join(JPEG_FIXTURES, 'digests.json')) as f:
        digests = json.load(f)
    bad = []
    for name, want in sorted(digests.items()):
        buf = np.fromfile(osp.join(JPEG_FIXTURES, name), np.uint8)
        for reduce in (1, 2):
            img = jpeg.decode_jpeg(buf, reduce, name)
            got = dict(shape=list(img.shape),
                       sha256=hashlib.sha256(img).hexdigest())
            if got != want[str(reduce)]:
                bad.append((name, reduce))
    if bad:
        raise AssertionError(f'the C JPEG decoder differs from cv2 on {bad}')
    buf = np.fromfile(osp.join(JPEG_FIXTURES, 'frame_00.jpg'), np.uint8)
    ms = {}
    for reduce in (1, 2):
        jpeg.decode_jpeg(buf, reduce)
        t0 = time.perf_counter()
        for _ in range(RJ_DECODE_ITERS):
            jpeg.decode_jpeg(buf, reduce)
        ms[f'reduce{reduce}_ms'] = (time.perf_counter() - t0) / \
            RJ_DECODE_ITERS * 1e3
    png_path = osp.join(root, 'frame_00.png')
    write_png(png_path, jpeg.decode_jpeg(buf))
    with open(png_path, 'rb') as f:
        png = f.read()
    image_io.decode_png(png)
    t0 = time.perf_counter()
    for _ in range(RJ_DECODE_ITERS):
        image_io.decode_png(png)
    ms['png_same_image_ms'] = (time.perf_counter() - t0) / \
        RJ_DECODE_ITERS * 1e3
    return dict(fixtures=len(digests), frame_hw=list(CLI_FRAME_HW),
                jpeg_bytes=int(buf.size), png_bytes=len(png), **ms)


def write_jpeg_videos(root, videos=RJ_VIDEOS, entries=CLI_LIST):
    """``videos`` directories of ``entries`` img_{:05}.jpg entries, video
    v's entry i a copy of committed frame (i + 3 v) % 16; a labels file."""
    frames = sorted(n for n in os.listdir(JPEG_FIXTURES)
                    if n.startswith('frame_'))
    for v in range(videos):
        vdir = osp.join(root, 'frames', f'video_{v:03d}')
        os.makedirs(vdir)
        for i in range(entries):
            shutil.copyfile(osp.join(JPEG_FIXTURES,
                                     frames[(i + 3 * v) % len(frames)]),
                            osp.join(vdir, f'img_{i:05d}.jpg'))
    labels = osp.join(root, 'labels.txt')
    with open(labels, 'w') as f:
        f.writelines(f'video_{v:03d} {v}\n' for v in range(videos))
    return osp.join(root, 'frames'), labels


class _Counted:
    """Patch ``module.name`` with a wrapper that hands each call's
    arguments and result to ``seen`` (thread-safe); ``restore`` undoes
    it."""

    def __init__(self, module, name, seen):
        import threading
        self.module, self.name = module, name
        self.real, lock = getattr(module, name), threading.Lock()

        def wrapper(*args, **kwargs):
            out = self.real(*args, **kwargs)
            with lock:
                seen(args, kwargs, out)
            return out
        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.real)


def phase_readme_jpeg(root):
    """The README's chain from JPEG frames to a fine-tuned model, through
    the CLIs, on the card, with neither cv2 nor msgpack: the fixtures'
    digests through the C decoder and the native LZ4 codec loaded; a
    Kinetics-shaped set of JPEG frames; ``flow_extraction`` (RAFT from
    seeded random weights, 128x171, gap 2, adjacent 8); the MDS tool
    (motion_map); the flagship config for 1 epoch of RJ_STEPS steps from
    the JPEG frames (at MoCoDecodePlan's reduce), the .np4 flows and the
    MDS chosen_idx; the fine-tune config from its checkpoint for 1 epoch
    on the same frames. Fails unless the digests match, the codecs are
    native, the lookup launches 12 times a RAFT forward and decayed
    InfoNCE 7 + 7 times a train step, every chosen_idx is non-empty and
    inside its flow timeline, MDS read the bytes extraction wrote, and
    every loss is finite."""
    t_phase = time.perf_counter()
    root = osp.join(root, 'readme_jpeg')
    os.makedirs(root)
    decode = jpeg_decoder_check(root)
    if np4._native() is None or jpeg._lib() is None:
        raise AssertionError('the native LZ4 codec or the C JPEG decoder '
                             'is not loaded')
    t0 = time.perf_counter()
    frames_root, labels = write_jpeg_videos(root)
    write_s = time.perf_counter() - t0

    # extraction: RAFT forwards counted and timed, the blobs' digests kept
    forwards, written = [], []
    real_make = extraction_cli.make_raft_fn

    def make_counted(*args, **kwargs):
        raft_fn = real_make(*args, **kwargs)

        def counted(img1, img2):
            t0 = time.perf_counter()
            out = raft_fn(img1, img2)
            forwards.append(time.perf_counter() - t0)
            return out
        return counted
    extraction_cli.make_raft_fn = make_counted
    encode = _Counted(extraction_cli, 'np4_encode', lambda a, k, out:
                      written.append(hashlib.sha256(out).hexdigest()))
    annos_pkl = osp.join(root, 'annos.pkl')
    try:
        _, _, extract_s = cli_run(extraction_cli.main, [
            frames_root, osp.join(root, 'flows'), '--anno-out', annos_pkl,
            '--labels', labels, '--scale-hw', *map(str, CLI_FLOW_HW),
            '--gap', '2', '--adjacent', '8'])
        corr_launches = cl.corr_lookup.launches
    finally:
        extraction_cli.make_raft_fn = real_make
        encode.restore()
    with open(annos_pkl, 'rb') as f:
        annos = pickle.load(f)
    n_flows = len(extraction_cli.window_indices(CLI_LIST, 2, 8))
    pairs = RJ_VIDEOS * n_flows
    if [len(a['enc_flows']) for a in annos] != [n_flows] * RJ_VIDEOS or \
            len(written) != pairs or \
            corr_launches != RAFT_ITERS * len(forwards) or \
            len(forwards) != RJ_VIDEOS * -(-n_flows // EXTRACT_PAIRS):
        raise AssertionError(f'{len(annos)} videos, {len(written)} blobs, '
                             f'{len(forwards)} RAFT forwards, '
                             f'{corr_launches} lookup launches')
    paths = [p for a in annos for p in a['enc_flows']]
    flow = np4.np4_decode(open(paths[0], 'rb').read())
    if flow.shape != CLI_FLOW_HW + (2,) or flow.dtype != np.float32 or \
            not all(np.isfinite(np4.np4_decode(open(p, 'rb').read())).all()
                    for p in paths[::40]):
        raise AssertionError(f'flow blob {flow.shape} {flow.dtype}')
    blob = np4.np4_encode(flow)
    codec_s = {}
    for name, fn, arg in (('encode', np4.np4_encode, flow),
                          ('decode', np4.np4_decode, blob)):
        t0 = time.perf_counter()
        for _ in range(20):
            fn(arg)
        codec_s[name] = (time.perf_counter() - t0) / 20

    # MDS: the bytes each flow read had
    read = {}

    def seen_read(args, kwargs, out):
        with open(args[0], 'rb') as f:
            read[args[0]] = hashlib.sha256(f.read()).hexdigest()
    load = _Counted(mds_cli, 'load_flow', seen_read)
    mds_pkl = osp.join(root, 'mds.pkl')
    try:
        t0 = time.perf_counter()
        mds = mds_cli.main([annos_pkl, mds_pkl, '--weight-type',
                            'motion_map'])
        mds_s = time.perf_counter() - t0
    finally:
        load.restore()
    if read != dict(zip(paths, written)):
        raise AssertionError('MDS read other bytes than extraction wrote')
    bad = [m['video_name'] for m in mds if not m['chosen_idx'] or not all(
        0 <= i < len(m['enc_flows']) for i in m['chosen_idx'])]
    if bad:
        raise AssertionError(f'chosen_idx empty or off the flow timeline '
                             f'in {bad}')

    # pretraining on the flagship config, then fine-tuning from it
    decodes = {1: 0, 2: 0}
    count = _Counted(image_io, 'decode_jpeg', lambda a, k, out:
                     decodes.__setitem__(a[1], decodes[a[1]] + 1))
    runs = {}
    try:
        for name, config, entries, extra in (
                ('pretrain', FLAGSHIP_CONFIG, mds, []),
                ('finetune', FT_CONFIG,
                 [dict(frames=a['frames'], label=a['label']) for a in annos],
                 [f'model.train_cfg.ssl_pretrain.pretrained.filename='
                  f'{osp.join(root, "pretrain", "epoch_1.pth")}'])):
            pkl = osp.join(root, f'{name}.pkl')
            with open(pkl, 'wb') as f:
                pickle.dump(entries * RJ_REPEAT, f)
            work = osp.join(root, name)
            _, launches, run_s = cli_run(train_cli.main, [
                config, '--seed', '0', '--cfg-options',
                f'data.train.pkl_path={pkl}', 'total_epochs=1',
                'checkpoint_config.interval=1', 'log_config.interval=1',
                f'work_dir={work}', *extra])
            records = [r for r in read_log(work) if r['mode'] == 'train']
            runs[name] = dict(
                steps=len(records), run_s=run_s, launches=launches,
                step_s=[r['time'] for r in records],
                data_time_s=[r['data_time'] for r in records],
                losses=[r['loss'] for r in records],
                checkpoint=osp.exists(osp.join(work, 'epoch_1.pth')))
            if len(records) == RJ_STEPS:
                runs[name].update(steady_window(records, RJ_STEPS, CLI_TAIL))
            if name == 'pretrain':
                runs[name]['jpeg_decodes_by_reduce'] = dict(decodes)
            torch.cuda.empty_cache()
    finally:
        count.restore()
    for name, run in runs.items():
        want = dict(l_neg=7 * RJ_STEPS, dq=7 * RJ_STEPS) \
            if name == 'pretrain' else dict(l_neg=0, dq=0)
        if run['steps'] != RJ_STEPS or run['launches'] != want or \
                not run['checkpoint'] or \
                not all(math.isfinite(v) for v in run['losses']):
            raise AssertionError(f'{name}: {run}; want {RJ_STEPS} steps, '
                                 f'launches {want}')
    if not runs['pretrain']['jpeg_decodes_by_reduce'][2]:
        raise AssertionError('no frame took the half-scale decode')
    steady = forwards[1:]
    log(phase='jpeg_decode', **decode)
    log(phase='np4_codec', flow_shape=list(flow.shape),
        raw_bytes=flow.nbytes, blob_bytes=len(blob),
        encode_mb_per_s=flow.nbytes / codec_s['encode'] / 1e6,
        decode_mb_per_s=flow.nbytes / codec_s['decode'] / 1e6,
        native=True)
    log(phase='readme_jpeg', videos=RJ_VIDEOS, frame_entries=CLI_LIST,
        frame_hw=list(CLI_FRAME_HW), flow_hw=list(CLI_FLOW_HW),
        data_write_s=write_s, extraction=dict(
            pairs=pairs, run_s=extract_s, pairs_per_s=pairs / extract_s,
            raft_forwards=len(forwards), corr_lookup_launches=corr_launches,
            forward_s_steady=sum(steady) / len(steady),
            blob_bytes=sum(osp.getsize(p) for p in paths)),
        mds=dict(videos=len(mds), run_s=mds_s, videos_per_s=len(mds) / mds_s,
                 flows_read=len(read),
                 chosen=[len(m['chosen_idx']) for m in mds]),
        **runs, phase_s=time.perf_counter() - t_phase)


def config_path(name):
    return osp.join(osp.dirname(FLAGSHIP_CONFIG), name + '.py')


def config_batch(model_cfg, bs, crop, seed):
    """A synthetic batch of a pretrain config's shapes: two 8-frame clips
    (and for MSCL the flows, base and rotated halves along T)."""
    if model_cfg['type'] == 'MSCLWithAug':
        return flagship_batch(bs, hw=crop, seed=seed)
    rng = np.random.default_rng(seed)
    return {'imgs': [rng.uniform(size=(bs, 3, 8, crop, crop))
                     .astype(np.float32) for _ in range(2)]}


def towers(model):
    """(prefix, tower) of each MoCo tower of a model."""
    if hasattr(model, 'recognizer'):
        return (('recognizer', model.recognizer),
                ('recognizer_flow', model.recognizer_flow))
    return (('', model),)


def config_steps(dev, name):
    """PC_STEPS train steps of a pretrain config's own model at full width
    on a synthetic batch of its shapes, then one profiled; fails unless
    every loss is finite, the queues and iters advance as the model
    implies and the decayed-InfoNCE launches are 7 + 7 (MSCL) or 1 + 1
    (MoCo) a step."""
    cfg = Config.fromfile(config_path(name))
    model_cfg = cfg.model.to_dict()
    mscl = model_cfg['type'] == 'MSCLWithAug'
    bs, crop = cfg.data['videos_per_gpu'], model_cfg['aug']['crop_size']
    model = build_model_from_cfg(model_cfg, device=dev, seed=0)
    lr = build_lr_schedule(cfg.lr_config.to_dict(), cfg.optimizer['lr'],
                           cfg.total_epochs, 1000)
    opt = build_optimizer(model, cfg.optimizer.to_dict(), lr,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    batch = to_torch(config_batch(model_cfg, bs, crop, seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, losses = [], []
    for _ in range(PC_STEPS):
        t0 = time.perf_counter()
        log_vars = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in log_vars.items()})
    launches = dict(l_neg=di.l_neg.launches, dq=di.dq.launches)
    per_step = 7 if mscl else 1
    if launches != dict(l_neg=per_step * PC_STEPS, dq=per_step * PC_STEPS):
        raise AssertionError(f'{name}: launches {launches}, want '
                             f'{per_step * PC_STEPS} each')
    bad = [(i, k) for i, lv in enumerate(losses) for k, v in lv.items()
           if k.startswith('loss') and not math.isfinite(v)]
    if bad or 'loss' not in losses[0]:
        raise AssertionError(f'{name}: non-finite losses {bad}')
    state, want = {}, {}
    for prefix, tower in towers(model):
        for n in ('queue_ptr', 'iters'):
            state[f'{prefix}.{n}'] = int(getattr(tower, n))
        # the flow tower runs twice a step and enqueues once
        want[f'{prefix}.queue_ptr'] = PC_STEPS * bs % tower.K
        want[f'{prefix}.iters'] = PC_STEPS * bs * (
            2 if prefix == 'recognizer_flow' else 1)
        if tower.K != K:
            raise AssertionError(f'{name}: K={tower.K}')
    if state != want:
        raise AssertionError(f'{name}: moco state {state} != {want}')
    peak = torch.cuda.max_memory_allocated()
    prof = profile(f'{name}_step', lambda: step(batch))
    row = dict(config=name, model=model_cfg['type'],
               aug=type(model.aug).__name__, batch=bs, crop=crop,
               params=sum(p.numel() for p in model.parameters()),
               step_ms=step_ms, device_busy_ms=prof['device_busy_ms'],
               device_idle_share=prof['device_idle_share'],
               profiled_wall_ms=prof['wall_ms'], peak_bytes=peak,
               launches=launches, state=state,
               losses=[{k: v for k, v in lv.items() if k.startswith('loss')}
                       for lv in losses])
    log(phase='pretrain_config_step', **row)
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return row


def narrow_moco_r18_cfg(name):
    """A moco_r18 config's model, narrowed: r3d_18 8 wide, one block a
    stage, K=32, dim 32, 32x32 crops."""
    cfg = Config.fromfile(config_path(name)).model.to_dict()
    cfg['backbone'] = dict(cfg['backbone'], layers=(1, 1, 1, 1),
                           base_width=8)
    cfg.update(dim_in=64, K=32, dim=32)
    cfg['aug'] = dict(cfg['aug'], crop_size=32)
    return cfg


def narrow_mscl_r50_cfg():
    """mscl_r50's model, narrowed: one block a stage, SlowOnly 4 wide, the
    TPN at its 128, r2d_50 2 wide (bkb_channels (None, 64)), K=32, dim 32,
    64x64 crops."""
    cfg = Config.fromfile(config_path('mscl_r50_cosm_lr3e-2')).model.to_dict()
    rgb, flow = cfg['recognizer'], cfg['recognizer_flow']
    rgb['backbone'] = dict(rgb['backbone'], stage_blocks=(1, 1, 1, 1),
                           base_channels=4)
    rgb['neck'] = dict(rgb['neck'], in_channels=[32, 64, 128])
    flow['backbone'] = dict(flow['backbone'], layers=(1, 1, 1, 1),
                            base_width=2)
    rgb.update(dim_in=128, K=32, dim=32)
    flow.update(dim_in=64, K=32, dim=32)
    cfg['sup_head'] = dict(cfg['sup_head'], bkb_channels=(None, 64))
    cfg['aug'] = dict(cfg['aug'], crop_size=64)
    return cfg


def configs_cli(root, pkls):
    """The training CLI on mscl_r50 (1 epoch of PC_CLI_STEPS steps, then a
    resume for a second) and on moco_r18_lr3e-2 (1 epoch), thread workers,
    over pretrain_cli's set (its videos listed to make PC_CLI_STEPS steps
    at each config's batch). The resume must load the state saved bitwise
    and its first step's logged values must equal those the run that saved
    it gives on the same batch (that run's model, kept in memory)."""
    with open(pkls[0], 'rb') as f:
        annos = pickle.load(f)[:CLI_VIDEOS]
    out = {}
    real_init, real_resume = train_loop.Runner.__init__, \
        train_loop.Runner.resume
    first, resumed = [], []

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        step = self._train_step

        def recorded(batch):
            log_vars = step(batch)
            if not first:
                first.append((batch, {k: v.item()
                                      for k, v in log_vars.items()}))
            return log_vars
        self._train_step = recorded

    def resume(self, path=None):
        real_resume(self, path)
        resumed.append(self.state())

    for name, epochs in (('mscl_r50_cosm_lr3e-2', (1, 2)),
                         ('moco_r18_lr3e-2', (1,))):
        cfg = Config.fromfile(config_path(name))
        bs = cfg.data['videos_per_gpu']
        pkl = osp.join(root, f'{name}_train.pkl')
        with open(pkl, 'wb') as f:
            pickle.dump([annos[i % len(annos)]
                         for i in range(PC_CLI_STEPS * bs)], f)
        work = osp.join(root, f'work_{name}')
        runs, launches, seconds = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for epoch in epochs:
            argv = [config_path(name), '--seed', '0', '--cfg-options',
                    f'data.train.pkl_path={pkl}', f'total_epochs={epoch}',
                    'checkpoint_config.interval=1', 'log_config.interval=1',
                    f'work_dir={work}']
            if epoch > 1:
                argv[1:1] = ['--resume-from',
                             osp.join(work, f'epoch_{epoch - 1}.pth')]
                train_loop.Runner.__init__ = init
                train_loop.Runner.resume = resume
            try:
                (runner, _), n, secs = cli_run(train_cli.main, argv)
            finally:
                train_loop.Runner.__init__ = real_init
                train_loop.Runner.resume = real_resume
            runs.append(runner)
            launches.append(n)
            seconds.append(secs)
        peak = torch.cuda.max_memory_allocated()
        per_epoch = len(runs[0].train_loader)
        mscl = cfg.model['type'] == 'MSCLWithAug'
        per_step = 7 if mscl else 1
        if per_epoch != PC_CLI_STEPS or any(
                n != dict(l_neg=per_step * per_epoch, dq=per_step * per_epoch)
                for n in launches):
            raise AssertionError(f'{name}: {per_epoch} steps an epoch, '
                                 f'launches {launches}')
        train = [r for r in read_log(work) if r['mode'] == 'train']
        bad = [r for r in train if not all(
            math.isfinite(v) for k, v in r.items() if k.startswith('loss'))]
        if bad or len(train) != per_epoch * len(epochs):
            raise AssertionError(f'{name}: {len(train)} train lines, '
                                 f'non-finite losses in {bad}')
        final = runs[-1].model
        state = {f'{p}.{n}': int(getattr(t, n)) for p, t in towers(final)
                 for n in ('queue_ptr', 'iters')}
        n = len(epochs) * per_epoch * bs
        want = {f'{p}.{k}': v for p, _ in towers(final) for k, v in (
            ('queue_ptr', n % K),
            ('iters', n * (2 if p == 'recognizer_flow' else 1)))}
        if state != want:
            raise AssertionError(f'{name}: moco state {state} != {want}')
        row = dict(config=name, batch=bs, steps_per_epoch=per_epoch,
                   epochs=len(epochs), launches=launches, run_s=seconds,
                   peak_bytes=peak, state=state,
                   losses=[r['loss'] for r in train],
                   **steady_window(train, per_epoch, CLI_TAIL))
        if len(epochs) > 1:
            saved = runs[0].state()
            diff = states_equal(saved, resumed[0])
            if diff or len(resumed) != 1:
                raise AssertionError(f'{name}: the state loaded at resume '
                                     f'differs from the state saved: '
                                     f'{diff[:10]}')
            batch, got = first[0]
            want_vars = {k: v.item() for k, v in
                         runs[0]._train_step(batch).items()}
            if got != want_vars:
                raise AssertionError(f'{name}: the resumed first step '
                                     f'{got} != the saving run\'s '
                                     f'{want_vars}')
            row['resumed_first_step'] = {k: v for k, v in got.items()
                                         if k.startswith('loss')}
        log(phase='pretrain_config_cli', **row)
        out[name] = row
        del runs, final
        torch.cuda.empty_cache()
    return out


def jpeg_encoder_check():
    """The C JPEG encoder on the committed cases (RGB and grey, sizes that
    are not multiples of 16, three qualities) against the sha256 of cv2's
    bytes (tests/test_torch_jpeg_encode.py writes them; this machine has
    no cv2). Returns the number of cases."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        '_torch_jpeg_encode_util', osp.join(
            osp.dirname(osp.abspath(__file__)), 'tests',
            '_torch_jpeg_encode_util.py'))
    eu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eu)
    with open(eu.DIGESTS) as f:
        digests = json.load(f)
    jpeg._encoder()                 # raises unless the C library loads
    if sorted(digests) != sorted(eu.cases()):
        raise AssertionError('the digests do not cover the cases')
    bad = [name for name in eu.cases()
           if eu.sha256(jpeg.encode_jpeg(*eu.case_image(name))) !=
           digests[name]]
    if bad:
        raise AssertionError(f'the C JPEG encoder differs from cv2 on {bad}')
    return len(digests)


class _CaptureLookup:
    """Wrap RAFT's correlation lookup: keep the operands of the last call
    (a copy), so the kernel can be held against its plain version on what
    the path gave it."""

    def __init__(self):
        from mscl_torch.flow import raft as raft_mod
        self.mod, self.real, self.last = raft_mod, raft_mod.corr_lookup, None

        def wrapper(f1, pyr, coords, levels, radius):
            self.last = (f1.clone(), pyr, coords.clone(), levels, radius)
            return self.real(f1, pyr, coords, levels, radius)
        raft_mod.corr_lookup = wrapper

    def restore(self):
        self.mod.corr_lookup = self.real


def arflow_card_vs_cpu(frames_root):
    """PWC-Lite from the same seeded weights on the card and on the CPU, on
    the extraction CLI's first pairs (padded to 128x192 as it pads them):
    every level of the forward flow within ARFLOW_REL of its largest
    entry. Returns the largest share, the PWC-Lite device ms of a batch of
    EXTRACT_PAIRS pairs and that batch's shape."""
    from mscl_torch.flow.pwclite import build_pwclite
    vdir = osp.join(frames_root, sorted(os.listdir(frames_root))[0])
    files = sorted(os.listdir(vdir))
    load = [image_io.imresize(image_io.imread_rgb(osp.join(vdir, f)),
                              CLI_FLOW_HW[::-1]) for f in files]
    pairs = np.stack([np.stack([load[i], load[i + 8]])
                      for i in range(0, 2 * EXTRACT_PAIRS, 2)])
    h, w = CLI_FLOW_HW
    pairs = np.pad(pairs, ((0, 0), (0, 0), (0, -h % 64), (0, -w % 64),
                           (0, 0)), mode='edge')
    x = torch.from_numpy((pairs / 255.0).astype(np.float32))
    flows, worst = {}, 0.0
    for dev in ('cpu', 'cuda'):
        model = build_pwclite(dev, seed=0)
        with torch.inference_mode():
            flows[dev] = [f.cpu() for f in model(
                x[:ARFLOW_CHECK_PAIRS].to(dev))['flows_fw']]
    for level, (cpu, card) in enumerate(zip(flows['cpu'], flows['cuda'])):
        share = ((card - cpu).abs().max() / cpu.abs().max()).item()
        if not share <= ARFLOW_REL:
            raise AssertionError(f'PWC-Lite level {level}: card against CPU '
                                 f'{share} of the largest entry')
        worst = max(worst, share)
    xb = x.cuda()
    with torch.inference_mode():
        ms = time_ms(lambda: model(xb), iters=10)
    return worst, ms, list(x.shape)


def warm_flow_fn(method, frames_root):
    """The extraction CLI's flow function for ``method`` on the card,
    built and run once on its first batch of the first video (the
    timed run's shape). Returns the function and the seconds taken."""
    t0 = time.perf_counter()
    if method == 'raft':
        flow_fn = make_raft_fn(None, RAFT_ITERS, 'cuda')
    else:
        flow_fn = extraction_cli.make_arflow_fn(device='cuda')
    vdir = osp.join(frames_root, sorted(os.listdir(frames_root))[0])
    files = sorted(os.listdir(vdir))
    load = [image_io.imresize(image_io.imread_rgb(osp.join(vdir, f)),
                              CLI_FLOW_HW[::-1], 'bilinear')
            for f in files[:EXTRACT_PAIRS + 8]]
    flow_fn(np.stack(load[:EXTRACT_PAIRS]), np.stack(load[8:]))
    torch.cuda.synchronize()
    return flow_fn, time.perf_counter() - t0


def vis_flow_timing(argv):
    """vis_flow's RAFT forward on the pairs the tool makes of ``argv``,
    warm: the function the tool calls (the pad, the copies and the copy
    back; host clock) and the model alone (device time, CUDA events),
    each built and run once before FT_TIMED_ITERS timed calls. Returns
    the host ms of each call and the mean device ms."""
    args = vis_flow_cli.parse_args(argv)
    frames = vis_flow_cli.load_frames(args.frame_dir, args.resize)
    idx1, idx2 = vis_flow_cli.pair_indices(len(frames), args.gap,
                                           args.adjacent)
    img1 = np.stack([frames[i] for i in idx1])
    img2 = np.stack([frames[i] for i in idx2])
    raft_fn = make_raft_fn(None, iters=args.iters, device='cuda')
    raft_fn(img1, img2)
    host = []
    for _ in range(FT_TIMED_ITERS):
        t0 = time.perf_counter()
        raft_fn(img1, img2)
        host.append((time.perf_counter() - t0) * 1e3)
    del raft_fn
    h, w = img1.shape[1:3]
    pad = ((0, 0), (0, -h % 8), (0, -w % 8), (0, 0))
    x1, x2 = (torch.from_numpy(np.pad(im, pad, mode='edge')).cuda()
              .permute(0, 3, 1, 2).contiguous() for im in (img1, img2))
    model = build_raft(None, device='cuda', iters=args.iters)
    with torch.inference_mode():
        device_ms = time_ms(lambda: model(x1, x2), iters=FT_TIMED_ITERS)
    return host, device_ms


def phase_flow_tooling(root):
    """The flow and motion tooling through its entry points, on the card,
    with neither cv2 nor msgpack: the C JPEG encoder against cv2's digests;
    ``flow_extraction --method arflow`` (PWC-Lite from seeded weights at
    128x171, padded to 128x192; no lookup launch), PWC-Lite card against
    CPU; ``--method raft`` on the same frames, then ``flow2img
    --with-bboxes`` and ``visualize_samples`` on its blobs; ``vis_flow`` on
    one video at 256x340 and with ``--resize 171 128``, the lookup counted
    (12 launches a RAFT forward) and held against its plain version on the
    operands of the run's last call. Fails unless every check holds. The
    times are taken warm, each model built before its window: the
    extraction CLI is handed its flow function built and run once on the
    run's shape, and vis_flow's forward is timed apart from the checked
    run (whose operands are copied for the check)."""
    t_phase = time.perf_counter()
    root = osp.join(root, 'flow_tooling')
    os.makedirs(root)
    cases = jpeg_encoder_check()
    frames_root, labels = write_jpeg_videos(root, FT_TOOL_VIDEOS,
                                            FT_TOOL_ENTRIES)
    n_flows = len(extraction_cli.window_indices(FT_TOOL_ENTRIES, 2, 8))

    # extraction: ARFlow (no lookup), then RAFT for the tools' blobs
    runs = {}
    for method in ('arflow', 'raft'):
        pkl = osp.join(root, f'{method}.pkl')
        flow_fn, build_s = warm_flow_fn(method, frames_root)
        maker = 'make_raft_fn' if method == 'raft' else 'make_arflow_fn'
        real = getattr(extraction_cli, maker)
        setattr(extraction_cli, maker, lambda *args, **kwargs: flow_fn)
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            extraction_cli.main([
                frames_root, osp.join(root, f'flows_{method}'),
                '--anno-out', pkl, '--labels', labels, '--method', method,
                '--scale-hw', *map(str, CLI_FLOW_HW), '--gap', '2',
                '--adjacent', '8'])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            setattr(extraction_cli, maker, real)
        del flow_fn
        with open(pkl, 'rb') as f:
            annos = pickle.load(f)
        paths = [p for a in annos for p in a['enc_flows']]
        flows = [np4.np4_decode(open(p, 'rb').read()) for p in paths]
        want = RAFT_ITERS * FT_TOOL_VIDEOS * -(-n_flows // EXTRACT_PAIRS) \
            if method == 'raft' else 0
        if len(paths) != FT_TOOL_VIDEOS * n_flows or any(
                f is None or f.shape != CLI_FLOW_HW + (2,) or
                not np.isfinite(f).all() for f in flows) or \
                cl.corr_lookup.launches != want:
            raise AssertionError(f'{method}: {len(paths)} blobs, lookup '
                                 f'launches {cl.corr_lookup.launches} != '
                                 f'{want}')
        runs[method] = dict(pairs=len(paths), run_s=run_s,
                            pairs_per_s=len(paths) / run_s,
                            build_and_warm_s=build_s,
                            lookup_launches=cl.corr_lookup.launches)
    arflow_rel, pwclite_ms, pwclite_batch = arflow_card_vs_cpu(frames_root)

    # flow2img on RAFT's blobs: the images decode to their flow's shape,
    # one box a frame
    raft_pkl = osp.join(root, 'raft.pkl')
    flow2img_s = []
    for r in range(FT_FLOW2IMG_RUNS):
        t0 = time.perf_counter()
        out = flow2img_cli.main([
            raft_pkl, osp.join(root, f'flowimgs_{r}'),
            osp.join(root, f'flow2img_{r}.pkl'), '--with-bboxes'])
        flow2img_s.append(time.perf_counter() - t0)
        for anno in out:
            if len(anno['imflows']) != n_flows or \
                    anno['gt_bboxes'].shape != (FT_TOOL_ENTRIES, 4) or \
                    anno['gt_bboxes'].dtype != np.float32:
                raise AssertionError(
                    f'flow2img: {len(anno["imflows"])} images, boxes '
                    f'{anno["gt_bboxes"].shape}')
            for p in anno['imflows']:
                img = jpeg.decode_jpeg(np.fromfile(p, np.uint8), 1, p)
                if img.shape != CLI_FLOW_HW + (3,):
                    raise AssertionError(f'{p}: {img.shape}')
    all_flows = [[np4.np4_decode(open(p, 'rb').read())
                  for p in anno['enc_flows']] for anno in out]
    flow_img = flow_viz.flow_to_image(all_flows[0][0])
    jpeg.encode_jpeg(flow_img)
    t0 = time.perf_counter()
    for _ in range(ENCODE_ITERS):
        jpeg.encode_jpeg(flow_img)
    encode_ms = (time.perf_counter() - t0) / ENCODE_ITERS * 1e3
    bbox_ms = []
    for _ in range(FT_BBOX_PASSES):
        for video_flows in all_flows:
            t0 = time.perf_counter()
            flow_bbox.inference_bboxs(FT_TOOL_ENTRIES, video_flows, gap=2,
                                      adjacent=8)
            bbox_ms.append((time.perf_counter() - t0) * 1e3)

    sheets = samples_cli.main([raft_pkl, osp.join(root, 'sheets'),
                               '--num-videos', str(FT_TOOL_VIDEOS),
                               '--frames-per-video', '4'])
    if len(sheets) != FT_TOOL_VIDEOS or not all(
            jpeg.decode_jpeg(np.fromfile(p, np.uint8), 1, p).shape ==
            (4 * CLI_FLOW_HW[0], 3 * CLI_FLOW_HW[1], 3) for p in sheets):
        raise AssertionError(f'visualize_samples wrote {sheets}')

    # vis_flow on one video, at the frames' size and resized: the checked
    # run, then its forward timed warm
    vdir = osp.join(frames_root, sorted(os.listdir(frames_root))[0])
    vis = {}
    for name, extra in (('full', []),
                        ('resized', ['--resize', *map(str,
                                                      CLI_FLOW_HW[::-1])])):
        capture = _CaptureLookup()
        out_dir = osp.join(root, f'vis_flow_{name}')
        try:
            reset_launch_counts()
            flows, boxes = vis_flow_cli.main([vdir, '--out-dir', out_dir,
                                              *extra])
            torch.cuda.synchronize()
            launches = cl.corr_lookup.launches
        finally:
            capture.restore()
        f1, pyr, coords, _, _ = capture.last
        errs, _ = corr_check(f'vis_flow {name}', f1, pyr, coords)
        n_pairs = len(vis_flow_cli.pair_indices(FT_TOOL_ENTRIES, 8, 8)[0])
        hw = CLI_FLOW_HW if name == 'resized' else CLI_FRAME_HW
        written = sorted(os.listdir(out_dir))
        if launches != RAFT_ITERS or flows.shape != (n_pairs,) + hw + (2,) \
                or not np.isfinite(flows).all() or \
                len(boxes) != FT_TOOL_ENTRIES or written != \
                ['bboxes.npy'] + [f'flow_{k:04d}.jpg' for k in range(n_pairs)]:
            raise AssertionError(f'vis_flow {name}: {launches} lookup '
                                 f'launches, flows {flows.shape}, '
                                 f'{len(boxes)} boxes, files {written}')
        feature_hw = list(f1.shape[1:3])
        del capture, f1, pyr, coords
        host_ms, device_ms = vis_flow_timing([vdir, *extra])
        vis[name] = dict(launches=launches, pairs=n_pairs, hw=list(hw),
                         feature_hw=feature_hw,
                         raft_fn_ms=host_ms,
                         raft_fn_ms_median=float(np.median(host_ms)),
                         raft_model_device_ms=device_ms, **errs)
    seconds = time.perf_counter() - t_phase
    log(phase='flow_tooling', encoder_cases=cases,
        arflow=dict(**runs['arflow'], pwclite_batch=pwclite_batch,
                    pwclite_device_ms_batch=pwclite_ms,
                    card_vs_cpu_rel=arflow_rel),
        raft=runs['raft'], vis_flow=vis, jpeg_encode_ms_128x171=encode_ms,
        flow2img=dict(videos=len(out), run_s=flow2img_s,
                      videos_per_s=[len(out) / t for t in flow2img_s]),
        inference_bboxs=dict(
            calls=len(bbox_ms), ms_median=float(np.median(bbox_ms)),
            ms_min=min(bbox_ms), ms_max=max(bbox_ms)),
        visualize_samples=len(sheets), seconds=seconds)
    return vis['resized']['launches']


# ---------------------------------------------------- recognition configs

def write_recognition_sets(root):
    """The phase's synthetic sets: RC_VIDEOS Kinetics-shaped videos of
    RC_FRAMES img_{:05}.jpg frames from 1 at RC_HW (16 distinct frames,
    encoded once by the port's JPEG encoder, video v's frame i a copy of
    (i + 3 v) % 16), the same videos as grey x_/y_{:05d}.jpg flow pairs,
    train and val lists, and an NTU-shaped skeleton pickle of RC_POSE
    samples (2 persons, 17 COCO keypoints, RC_POSE_FRAMES frames at
    RC_POSE_HW). Returns {set: (data_prefix, train list, val list)}."""
    rng = np.random.default_rng(0)
    h, w = RC_HW
    ys, xs = np.mgrid[0:h, 0:w]
    encoded = []
    for k in range(16):
        img = np.stack([(xs * (k + 1) + ys * 3) % 256, (ys * 2 + k * 16) %
                        256, (xs + ys + k * 40) % 256], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
            np.uint8)
        encoded.append((jpeg.encode_jpeg(img, 90),
                        jpeg.encode_jpeg(img[..., 0], 90),
                        jpeg.encode_jpeg(img[..., 1], 90)))
    sets = {}
    for kind in ('rgb', 'flow'):
        base = osp.join(root, f'kinetics_{kind}')
        lines = []
        for v in range(RC_VIDEOS):
            vdir = osp.join(base, f'video_{v:03d}')
            os.makedirs(vdir)
            for i in range(1, RC_FRAMES + 1):
                rgb, x, y = encoded[(i + 3 * v) % 16]
                files = ([(f'img_{i:05}.jpg', rgb)] if kind == 'rgb' else
                         [(f'x_{i:05d}.jpg', x), (f'y_{i:05d}.jpg', y)])
                for name, data in files:
                    with open(osp.join(vdir, name), 'wb') as f:
                        f.write(data)
            lines.append(f'video_{v:03d} {RC_FRAMES} {v % 400}\n')
        for split, rows in (('train', lines), ('val', lines[:RC_VAL])):
            with open(osp.join(base, f'{split}.txt'), 'w') as f:
                f.writelines(rows)
        sets[kind] = (base, osp.join(base, 'train.txt'),
                      osp.join(base, 'val.txt'))
    samples = []
    for i in range(RC_POSE):
        base = rng.uniform(10, RC_POSE_HW[0] - 10, (2, 1, 17, 2))
        kp = base + np.cumsum(rng.normal(0, 0.6, (2, RC_POSE_FRAMES, 17, 2)),
                              axis=1)
        samples.append(dict(
            frame_dir=f'S001C001P001R001A{i:03d}', label=i % 60,
            total_frames=RC_POSE_FRAMES, img_shape=RC_POSE_HW,
            original_shape=RC_POSE_HW, keypoint=kp.astype(np.float32),
            keypoint_score=rng.uniform(0.2, 1, (2, RC_POSE_FRAMES, 17))
            .astype(np.float32)))
    base = osp.join(root, 'ntu')
    os.makedirs(base)
    for split, rows in (('train', samples), ('val', samples[:RC_VAL * 2])):
        with open(osp.join(base, f'{split}.pkl'), 'wb') as f:
            pickle.dump(rows, f)
    sets['pose'] = (None, osp.join(base, 'train.pkl'),
                    osp.join(base, 'val.pkl'))
    return sets


def recognition_options(sets, kind, work):
    """--cfg-options that point a config's splits at the phase's set and
    cut its run to one epoch, with a checkpoint, validation and a log line
    every epoch and step."""
    prefix, train, val = sets[kind]
    opts = []
    for split, ann in (('train', train), ('val', val), ('test', val)):
        opts.append(f'data.{split}.ann_file={ann}')
        if prefix:
            opts.append(f'data.{split}.data_prefix={prefix}')
    return opts + ['total_epochs=1', 'checkpoint_config.interval=1',
                   'evaluation.interval=1', 'log_config.interval=1',
                   f'work_dir={work}']


def narrow_recognizer(model_cfg):
    """A recognition config's model, narrowed: base_channels 8, one block
    a stage, dropout 0."""
    cfg = json.loads(json.dumps(model_cfg))
    stages = cfg['backbone'].get('num_stages', 4)
    cfg['backbone'].update(base_channels=8, stage_blocks=[1] * stages)
    cfg['cls_head'].update(in_channels=8 * 2 ** (stages - 1) * 4,
                           dropout_ratio=0.0)
    return cfg


def _fitted(init, target):
    """``init`` (a state dict) in the shapes of ``target``'s: an entry of
    another shape sliced to the target's from its start in every axis
    (TimeSformer's ``pos_embed`` and ``time_embed`` for a clip cut in
    frames and crop, a Swin block's bias table for a smaller window)."""
    out = {}
    for k, want in target.items():
        v = init[k]
        if v.shape != want.shape:
            if v.dim() != want.dim() or any(a < b for a, b in
                                            zip(v.shape, want.shape)):
                raise ValueError(f'{k}: {tuple(v.shape)} does not cover '
                                 f'{tuple(want.shape)}')
            v = v[tuple(slice(0, n) for n in want.shape)]
        out[k] = v
    return out


def _recognition_model(model_cfg, dev, dtype, init=None):
    """A config's model on ``dev`` in ``dtype`` from seed 1, or with
    ``init`` (a float32 state dict on the host, from such a build) built
    on the meta device and given those weights, fitted to its shapes
    (``_fitted``), with no initialiser run (float32 without TF32, as the
    port's train_model runs); logits from forward_test; TRN's training
    subsets drawn from one CPU stream on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(model_cfg, dtype=dtype)
    blocks = cfg.pop('stage_blocks_cut', None)
    if init is None:
        model = build_model_from_cfg(cfg, device=dev, seed=1).to(dtype)
    else:
        from mscl_torch.models import RECOGNIZERS
        with torch.device('meta'):
            model = RECOGNIZERS.get(cfg.pop('type'))(**cfg)
        model = model.to_empty(device=dev)
        model.load_state_dict(_fitted(init, model.state_dict()))
        if hasattr(model, 'seed_dropout'):
            model.seed_dropout(1)
        model = model.to(dtype)
    if blocks is not None:              # depth_cut: each stage's first blocks
        for i in range(1, model.backbone.num_stages + 1):
            name = f'layer{i}'
            setattr(model.backbone, name,
                    getattr(model.backbone, name)[:blocks])
    model.test_cfg['average_clips'] = None          # logits, not softmaxes
    head = model.cls_head
    if hasattr(head, 'relation_picks'):
        gen = torch.Generator().manual_seed(3)
        head.relation_picks = lambda n, k, device: (
            torch.randperm(n, generator=gen)[:k] if head.training and n > k
            else torch.arange(k)).to(device)
    neck = getattr(model, 'neck', None)
    if hasattr(neck, 'dropout_ratio'):
        # TPN's fixed aux dropout: its masks from one CPU stream everywhere
        ngen = torch.Generator().manual_seed(4)

        def dropout(x, p=neck.dropout_ratio):
            if not neck.training:
                return x
            keep = torch.rand(x.shape, generator=ngen) >= p
            return torch.where(keep.to(x.device), x / (1 - p),
                               torch.zeros_like(x))
        neck.dropout = dropout
    return model


def _on(batch, dev, dtype):
    on_dev = to_torch(batch, dev)
    on_dev['imgs'] = on_dev['imgs'].to(dtype)
    return on_dev


def _logits(model, batch, dev, dtype):
    model.eval()
    with torch.no_grad():
        return model.forward_test(_on(batch, dev, dtype)['imgs']).cpu() \
            .double()


def _recognition_run(model_cfg, cfg, batch, dev, steps, fault=None,
                     dtype=torch.float32, logits=True, at=None,
                     step_batch=None, step_cfg=None, init=None,
                     cut_logits=False, own64=False):
    """forward_test's logits (eval mode, before any step; with
    ``logits``, on ``batch``), then with ``steps`` >= 1 one train step: its
    loss, each parameter's gradient and update (the weights after it less
    those before, as ``state``), in ``dtype``; with ``steps`` 2 the loss in
    train mode (no backward, no update) at the weights after the step, or
    at ``at`` (a state dict) where given. The steps take ``step_batch``
    (the batch cut, or None: ``batch``) through the model of ``step_cfg``
    (None: ``model_cfg``'s), whose weights are the first model's
    (``_fitted``), and with ``cut_logits`` its logits on ``step_batch``
    (``cut_logits``) come before the step. With ``own64`` (the card) the
    logits on ``batch`` also in float64 from the same weights
    (``logits64``). The model is built from seed 1, or from ``init``
    (``out['init']`` of a float32 run: one initialiser a config). Under
    ``fault`` (a context manager, or None) the whole run. Gradients and
    updates stay in ``dtype``, on the CPU."""
    model = _recognition_model(model_cfg, dev, dtype, init)
    out = dict(losses=[], grads={}, updates={}, init=init)
    if init is None:
        out['init'] = {k: v.detach().to('cpu', torch.float32, copy=True)
                       for k, v in model.state_dict().items()}
    with fault or contextlib.nullcontext():
        if logits:
            out['logits'] = _logits(model, batch, dev, dtype)
        if own64:
            wide = _recognition_model(model_cfg, dev, torch.float64,
                                      out['init'])
            out['logits64'] = _logits(wide, batch, dev, torch.float64)
            del wide
        if not steps and not cut_logits:
            return out
        if step_cfg is not None:
            del model
            model = _recognition_model(step_cfg, dev, dtype, out['init'])
        if cut_logits:
            out['cut_logits'] = _logits(
                model, batch if step_batch is None else step_batch, dev,
                dtype)
        if not steps:
            return out
        on_dev = _on(batch if step_batch is None else step_batch, dev,
                     dtype)
        opt = build_optimizer(
            model, cfg.optimizer.to_dict(),
            build_lr_schedule({}, cfg.optimizer['lr'], 1, 2),
            grad_clip=(cfg.get('optimizer_config') or {}).get('grad_clip'))
        before = {n: q.detach().clone()
                  for n, q in model.named_parameters()}
        out['losses'].append(
            make_train_step(model, opt)(on_dev)['loss'].item())
        for n, q in model.named_parameters():
            if q.grad is not None:
                out['grads'][n] = q.grad.cpu()
                out['updates'][n] = (q.detach() - before[n]).cpu()
        out['state'] = {k: v.cpu() for k, v in model.state_dict().items()}
        if steps > 1:
            if at is not None:
                model.load_state_dict(at)
            out['losses'].append(make_train_step(model, update=False)(
                on_dev)['loss'].item())
    return out


def _rel_errors(got, ref):
    """Each parameter's tensor in ``got`` (a dict by name): the norm of its
    gap from ``ref``'s over the norm of ``ref``'s."""
    out = {}
    for n, r in ref.items():
        if n in got:
            r, g = r.double(), got[n].double()
            out[n] = ((g - r).norm() / r.norm()).item() if r.norm() > 0 \
                else (0.0 if g.norm() == 0 else math.inf)
    return out


def _leaf_shares(card, cpu, ref, key):
    """Each parameter's ``key`` tensor (gradient or update): the card's
    gap from float64 (``_rel_errors``) as a share of what it may be:
    RC_F32_MULT times the CPU's float32 gap, that of the parameter or the
    median over the model's parameters where that is larger (a parameter
    of one or two numbers can land near float64 by chance in one
    rounding), and at least RC_GRAD_TOL. Returns (shares, card's gaps,
    CPU's gaps)."""
    card_rel, cpu_rel = _rel_errors(card[key], ref[key]), \
        _rel_errors(cpu[key], ref[key])
    rels = sorted(cpu_rel.values())
    typical = rels[len(rels) // 2] if rels else 0.0
    return {n: e / max(RC_GRAD_TOL, RC_F32_MULT * max(cpu_rel[n], typical))
            for n, e in card_rel.items()}, card_rel, cpu_rel


def _recognition_errors(card, cpu, ref):
    """The card's float32 run against the CPU's float32 run ``cpu`` and
    float64 run ``ref``: the logits' largest gap from the CPU's as a share
    of their spread (max - min; on the cut clip where the runs cut one,
    and then the card's own-clip logits against its float64 ones as
    ``own_logit_share``); the losses' largest gap, the step's from ref's
    and the second from the CPU's at the card's updated weights, as a
    share of RC_LOSS_TOL; each gradient's and update's as
    ``_leaf_shares`` bounds it, the largest of each."""
    key = 'cut_logits' if 'cut_logits' in cpu else 'logits'
    spread = (cpu[key].max() - cpu[key].min()).item()
    own = None
    if 'logits64' in card:
        wide = card['logits64']
        own = (card['logits'] - wide).abs().max().item() / \
            (wide.max() - wide.min()).item()
    loss_diff = max((abs(a - r) for a, r in
                     list(zip(card['losses'][:1], ref['losses'])) +
                     list(zip(card['losses'][1:], cpu['losses'][1:]))),
                    default=None)
    share, card_rel, cpu_rel = _leaf_shares(card, cpu, ref, 'grads')
    upd_share = _leaf_shares(card, cpu, ref, 'updates')[0]
    worst = max(share, key=share.get, default=None)
    upd_worst = max(upd_share, key=upd_share.get, default=None)
    rels = sorted(card_rel.values())
    return dict(
        logit_share=(card[key] - cpu[key]).abs().max().item() / spread,
        logit_spread=spread, own_logit_share=own, loss_diff=loss_diff,
        loss_share=None if loss_diff is None else loss_diff / RC_LOSS_TOL,
        grad_share=share.get(worst), grad_worst=worst,
        grad_rel=card_rel.get(worst), cpu_grad_rel=cpu_rel.get(worst),
        grad_rel_median=rels[len(rels) // 2] if rels else None,
        grads_held=len(share),
        update_share=upd_share.get(upd_worst), update_worst=upd_worst,
        same_leaves=sorted(card['grads']) == sorted(ref['grads']))


def _recognition_held(err):
    return err['logit_share'] <= RC_LOGIT_TOL and err['same_leaves'] and \
        (err['own_logit_share'] or 0) <= RC_LOGIT_TOL and \
        all(err[k] is None or err[k] <= 1
            for k in ('loss_share', 'grad_share', 'update_share'))


def recognition_card_vs_cpu(pool, cfg, sets, kind, model_cfg, clips, steps,
                            fault=None, cut=None):
    """A config's model (``model_cfg``) on the card in float32 and on the
    CPU in float32 and float64 from the same weights, on one batch of
    ``clips`` clips from the config's own train pipeline
    (``_recognition_batch``): forward_test's logits before any step, then
    ``steps`` (0 or RC_CHECK_STEPS) as ``_recognition_run`` takes them,
    the CPU's second loss at the card's updated weights; the float64 run
    to the first step alone; all held as ``_recognition_errors`` measures
    and RC_CHECK_STEPS' note bounds. At full width one clip's first
    gradients are ill-conditioned: the CPU's own float32 lies percents
    from its float64 (cpu_grad_rel), and so does the loss after an update
    made with them. So the gradients and updates are held against float64
    with an allowance of the CPU's float32 gap, and the second loss at one
    set of weights. The logits and the second loss, well-conditioned, are
    held against the CPU's float32 (its gap from float64, about 1e-6,
    lies far under their bounds). With ``fault`` (a context manager that
    breaks the model: the planted-fault control) the card's run, to its
    first step, is made again under it and must fail.

    ``cut`` (or None), a function of the batch and ``model_cfg``, gives
    the steps' batch and model config (a clip cut in frames and crop, and
    for TimeSformer the model of that clip, its weights the config's
    model's, ``zoo_cut``; or the clip as it is and a model cut in depth,
    ``depth_cut``). Then the card's and the CPU's
    float32 logits are held on the cut clip, and the card's float32
    logits on the config's own clip against its float64 ones from the
    same weights (the CPU's forward on the own clip cost up to 5.5 times
    its float64 step on the cut one). The card runs here and the
    CPU's runs in a worker of ``pool`` (a ``reference_pool``); the
    returned function waits for them and raises if the check fails."""
    batch = _recognition_batch(cfg, sets, kind, clips)
    step_batch, step_cfg = cut(batch, model_cfg) if cut else (None, None)
    task = dict(cfg=cfg.filename, model_cfg=model_cfg, batch=batch,
                steps=steps, step_batch=step_batch, step_cfg=step_cfg,
                cut=cut is not None)
    t0 = time.perf_counter()
    task['card'] = _recognition_run(model_cfg, cfg, batch, 'cuda', steps,
                                    step_batch=step_batch, step_cfg=step_cfg,
                                    cut_logits=cut is not None,
                                    own64=cut is not None)
    init = task['card'].pop('init')
    if fault is not None:
        task['fault'] = _recognition_run(
            model_cfg, cfg, batch, 'cuda', min(steps, 1), fault,
            step_batch=step_batch, step_cfg=step_cfg, init=init,
            logits=cut is None, cut_logits=cut is not None)
        del task['fault']['init']
    del init
    card_s = time.perf_counter() - t0
    shape = list(batch['imgs'].shape)
    step_shape = None if step_batch is None else \
        list(step_batch['imgs'].shape)
    future = pool.submit(_cpu_reference, task)
    return lambda: _recognition_held_or_raise(cfg, shape, step_shape,
                                              card_s, *future.result())


def _cpu_reference(task):
    """The CPU's side of ``recognition_card_vs_cpu`` for one config, in a
    ``reference_pool`` worker: its float32 run (the second loss at the
    card's updated weights) and its float64 run, and the card's errors
    against them (and the planted fault's). Returns (errors, the fault's
    errors or None, the seconds of the CPU's float32 and float64 runs)."""
    t0 = time.perf_counter()
    cfg = Config.fromfile(task['cfg'])
    card, steps = task['card'], task['steps']
    kw = dict(step_batch=task['step_batch'], step_cfg=task['step_cfg'])
    cpu = _recognition_run(task['model_cfg'], cfg, task['batch'], 'cpu',
                           steps, at=card.get('state'),
                           logits=not task['cut'], cut_logits=task['cut'],
                           **kw)
    t1 = time.perf_counter()
    ref = _recognition_run(task['model_cfg'], cfg, task['batch'], 'cpu',
                           min(steps, 1), dtype=torch.float64, logits=False,
                           init=cpu.pop('init'), **kw)
    err = _recognition_errors(card, cpu, ref)
    fault = _recognition_errors(task['fault'], cpu, ref) \
        if task.get('fault') is not None else None
    return err, fault, dict(float32=t1 - t0,
                            float64=time.perf_counter() - t1)


def _recognition_held_or_raise(cfg, shape, step_shape, card_s, err, fault,
                               cpu_s):
    if not _recognition_held(err):
        raise AssertionError(f'{cfg.filename}: card vs CPU: {err}')
    out = dict(imgs=shape, **err, card_s=card_s,
               cpu_s=sum(cpu_s.values()), cpu_float64_s=cpu_s['float64'])
    if step_shape is not None:
        out['step_imgs'] = step_shape
    if fault is not None:
        out['fault'] = fault
        if _recognition_held(fault):
            raise AssertionError(f'the planted fault passed: {out}')
    return out


def _pool_task(fn, path):
    """A reference_pool worker's call: fn of the task in the file ``path``
    (removed here) on RC_POOL_THREADS threads."""
    torch.set_num_threads(RC_POOL_THREADS)
    task = torch.load(path, weights_only=False)
    os.remove(path)
    return fn(task)


def _warm_worker():
    """A reference worker's start: torch.optim's first optimizer imports
    torch._dynamo (about 10 s on the card's host), made here, before the
    worker's first task."""
    import torch._dynamo  # noqa: F401


_WORKERS = []


def reference_workers():
    """The script's RC_POOL spawned CPU workers of the recognition phases'
    references (``reference_pool``), started and warmed (``_warm_worker``)
    at the first call, while the kernels build: a worker of a pool of its
    own paid its start and its imports in the phase, about 15 s. Idle
    between the phases; stopped by ``stop_reference_workers``."""
    if not _WORKERS:
        import concurrent.futures
        import multiprocessing
        pool = concurrent.futures.ProcessPoolExecutor(
            RC_POOL, mp_context=multiprocessing.get_context('spawn'),
            initializer=_warm_worker)
        for _ in range(RC_POOL):       # one start each: none is idle yet
            pool.submit(os.getpid)
        _WORKERS.append(pool)
    return _WORKERS[0]


def stop_reference_workers():
    while _WORKERS:
        _WORKERS.pop().shutdown(wait=True, cancel_futures=True)


class reference_pool(contextlib.AbstractContextManager):
    """The script's reference workers (RC_POOL spawned CPU workers of
    RC_POOL_THREADS torch threads each, ``reference_workers``) for
    ``_cpu_reference`` (a float64 convolution on one clip runs on one
    thread, so the configs' CPU runs go side by side), and a directory for
    a phase's tasks. Only the card's side of the same phase runs beside
    them, never a CLI or a decode phase: on exit every task of the phase
    has ended or is cancelled."""

    def __init__(self, root):
        self.dir = tempfile.mkdtemp(prefix='cpu_refs_', dir=root)
        self._pool = reference_workers()
        self._futures = []

    def submit(self, fn, task):
        """fn(task) in a worker (a module-level function of a dict), the
        task passed through a file."""
        path = osp.join(self.dir, f'task_{len(self._futures)}.pt')
        torch.save(task, path)
        self._futures.append(self._pool.submit(_pool_task, fn, path))
        return self._futures[-1]

    def __exit__(self, *exc):
        import concurrent.futures
        for future in self._futures:
            future.cancel()
        concurrent.futures.wait(self._futures)
        shutil.rmtree(self.dir, ignore_errors=True)
        return False


def _recognition_batch(cfg, sets, kind, clips):
    """One batch of ``clips`` clips from the config's own train pipeline
    over the phase's set (the first set of a list; NTHWC clips formatted
    NCTHW; RGB frames named as the set names them)."""
    from mscl_torch.datasets import build_dataset
    from mscl_torch.datasets.loader import default_collate
    prefix, train, _ = sets[kind]
    ds_cfg = cfg.data.train
    ds_cfg = (ds_cfg[0] if isinstance(ds_cfg, list) else ds_cfg).to_dict()
    ds_cfg['ann_file'] = train
    if prefix:
        ds_cfg['data_prefix'] = prefix
    if kind == 'rgb' and 'filename_tmpl' in ds_cfg:
        ds_cfg['filename_tmpl'] = RC_RGB_TMPL      # the set's frame names
    for step_cfg in ds_cfg['pipeline']:
        if step_cfg.get('input_format') == 'NTHWC':
            step_cfg['input_format'] = 'NCTHW'
    random.seed(0)
    np.random.seed(0)
    dataset = build_dataset(ds_cfg)
    return default_collate([dataset[i] for i in range(clips)])


def recognition_train(cfg_path, sets, kind, validate, work, options=()):
    """The training CLI on a config file over the phase's set: 1 epoch at
    the config's batch (RC_STEPS steps at a batch of 8; TIN's 6 takes 5),
    validation where asked, then one more step profiled. Fails unless
    every loss is finite and neither decayed InfoNCE nor the lookup
    launched."""
    argv = [cfg_path, '--seed', '0', '--cfg-options',
            *recognition_options(sets, kind, work), *options]
    if validate:
        argv.insert(1, '--validate')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (runner, model), launches, run_s = cli_run(train_cli.main, argv)
    peak = torch.cuda.max_memory_allocated()
    launches['corr_lookup'] = cl.corr_lookup.launches
    if any(launches.values()):
        raise AssertionError(f'{cfg_path}: kernels launched {launches}')
    records = read_log(work)
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    if len(train) != len(runner.train_loader) or len(train) < RC_STEPS or \
            len(val) != int(validate) or not all(
                math.isfinite(r['loss']) for r in train):
        raise AssertionError(f'{cfg_path}: {len(train)} train lines, '
                             f'{len(val)} val lines, losses '
                             f'{[r["loss"] for r in train]}')
    if validate and not {'top1_acc', 'mean_class_accuracy'} <= set(val[0]):
        raise AssertionError(f'{cfg_path}: val line {val[0]}')
    steady = train[2:]
    step_s = sum(r['time'] for r in steady) / len(steady)
    it = iter(runner.train_loader)
    batch = to_torch(next(it), 'cuda')
    it.close()
    it._thread.join()
    name = osp.basename(work)
    prof = profile(f'{name}_step', lambda: runner._train_step(batch))
    row = dict(batch=runner.train_loader.batch_size,
               imgs=list(batch['imgs'].shape), steady_ms=step_s * 1e3,
               data_wait_share=sum(r['data_time'] for r in steady) /
               len(steady) / step_s,
               device_ms=prof['device_busy_ms'],
               idle_share=prof['device_idle_share'], peak_bytes=peak,
               losses=[r['loss'] for r in train], run_s=run_s,
               val={k: val[0][k] for k in ('top1_acc', 'top5_acc',
                                           'mean_class_accuracy')}
               if validate else None)
    del runner, model, batch
    torch.cuda.empty_cache()
    return row


def recognition_refusals(sets, root, nthwc=RC_NTHWC, refused=RC_REFUSED):
    """The configs the port refuses by name: the NTHWC ones stop before
    their first step with Recognizer3D's message (at one clip a batch: the
    channel check reads the clip's shape, not the batch's size); each of
    ``refused`` names its word (the PoseC3D limb config left_kp, a video
    config its video reader)."""
    out = {}
    for name in nthwc:
        work = osp.join(root, 'refused_' + name.split('/')[-1])
        try:
            cli_run(train_cli.main, [name, '--seed', '0', '--cfg-options',
                                     *recognition_options(sets, 'rgb', work),
                                     'data.videos_per_gpu=1'])
        except ValueError as e:
            if "FormatShape('NTHWC')" not in str(e):
                raise
            out[name] = str(e)[:60]
        else:
            raise AssertionError(f'{name} trained on NTHWC clips')
        logged = osp.join(work, 'log.json')
        if osp.exists(logged) and open(logged).read().strip():
            raise AssertionError(f'{name} logged a step before refusing')
    for name, word, kind in refused:
        work = osp.join(root, 'x')
        # kind None: no set (an option on data.train would replace a list)
        options = recognition_options(sets, kind, work) if kind else \
            [f'work_dir={work}']
        try:
            cli_run(train_cli.main, [name, '--cfg-options', *options])
        except (TypeError, NotImplementedError, KeyError) as e:
            if word not in str(e):
                raise
            out[name] = str(e)[:60]
        else:
            raise AssertionError(f'{name} was not refused')
    return out


def phase_recognition_configs(root):
    """The I3D, SlowOnly and PoseC3D recipes of configs/: data written,
    card against CPU, the training CLI on each trainable config, the test
    CLI on i3d_r50_dense's checkpoint, and the refusals. Each config runs
    its own model, batch, clip length and crop, float32."""
    from mscl_torch.apis import inference
    t_phase = time.perf_counter()
    root = osp.join(root, 'recognition')
    t0 = time.perf_counter()
    sets = write_recognition_sets(root)
    write_s = time.perf_counter() - t0
    pending = {}
    with reference_pool(root) as pool:      # stopped before the CLI runs
        for name, cfg_path, kind, _ in RECOGNITION_CONFIGS:
            cfg = Config.fromfile(cfg_path)
            pending[name] = recognition_card_vs_cpu(
                pool, cfg, sets, kind,
                narrow_recognizer(cfg.model.to_dict()), RC_CHECK,
                RC_CHECK_STEPS)
        checks = {name: finish() for name, finish in pending.items()}
    rows = {}
    for name, cfg_path, kind, validate in RECOGNITION_CONFIGS:
        rows[name] = dict(card_vs_cpu=checks[name], **recognition_train(
            cfg_path, sets, kind, validate, osp.join(root, name)))
        log(phase='recognition_config', config=cfg_path, **rows[name])
    dense = RECOGNITION_CONFIGS[0][1]
    work = osp.join(root, RECOGNITION_CONFIGS[0][0])
    out = osp.join(work, 'test.json')
    loop_s, restore = timed_calls(inference, 'run_test')
    try:
        metrics, launches, test_s = cli_run(test_cli.main, [
            dense, osp.join(work, 'epoch_1.pth'), '--out', out,
            '--cfg-options', *recognition_options(sets, 'rgb', work)])
    finally:
        restore()
    if any(launches.values()) or not all(0 <= v <= 1
                                         for v in metrics.values()):
        raise AssertionError(f'test CLI: {metrics}, {launches}')
    refusals = recognition_refusals(sets, root)
    seconds = time.perf_counter() - t_phase
    test = dict(videos=RC_VAL, clips_a_video=10, metrics=metrics,
                videos_per_s=RC_VAL / test_s,
                loop_videos_per_s=RC_VAL / sum(loop_s))
    log(phase='recognition_configs', write_s=write_s, test_cli=test,
        refusals=refusals, seconds=seconds,
        cut=f'skeletons at img_shape {RC_POSE_HW}, not NTU\'s 1080x1920: '
            f'the configs have no PoseCompact/Resize, so heatmaps come out '
            f'at img_shape')
    log(phase='recognition_configs', headline=dict(
        checks='card_vs_cpu against float64, finite losses, 0 kernel '
               'launches, test metrics, 4 refusals',
        seconds=round(seconds, 1), test_videos_per_s=round(
            test['videos_per_s'], 2),
        configs={k: [round(r['steady_ms'], 1),
                          round(r['data_wait_share'], 3),
                          round(r['device_ms'], 1),
                          round(r['idle_share'], 3),
                          round(r['peak_bytes'] / 2 ** 30, 2)]
                 for k, r in rows.items()},
        keys='steady_ms, data_wait_share, device_ms, idle_share, '
             'peak_GiB'))
    return root, sets


def full_width_check_cfg(model_cfg):
    """A config's own model, dropout 0 (the card's masks are not the
    CPU's)."""
    cfg = json.loads(json.dumps(model_cfg))
    cfg['cls_head']['dropout_ratio'] = 0.0
    return cfg


def rc2d_step_groups(paths):
    """Each config of RC2D_STEP_GROUPS -> its group's first (the one whose
    step check it shares), after checking that the group's model configs
    differ only in cls_head.num_classes and dropout_ratio, test_cfg and an
    empty train_cfg, and that their models, built on the meta device,
    have the same state dict keys and shapes but for the classifier's.
    The optimizer settings may differ (tsn_r50_ucf101's lr is 0.00128,
    its leader's 0.01): the shared step's update holds the leader's
    optimizer and grad_clip only; a follower's own are not held."""
    from mscl_torch.models import RECOGNIZERS

    def plain(label):
        cfg = Config.fromfile(paths[label]).model.to_dict()
        cfg.pop('test_cfg', None)
        if cfg.get('train_cfg') is None:
            cfg.pop('train_cfg', None)
        for key in ('num_classes', 'dropout_ratio'):
            cfg['cls_head'].pop(key, None)
        return cfg

    def shapes(label):
        cfg = Config.fromfile(paths[label]).model.to_dict()
        with torch.device('meta'):
            model = RECOGNIZERS.get(cfg.pop('type'))(**cfg)
        return {k: tuple(v.shape) for k, v in model.state_dict().items()
                if not k.startswith('cls_head.fc_cls')}
    leader = {}
    for group in RC2D_STEP_GROUPS:
        first = group[0]
        for label in group[1:]:
            if plain(label) != plain(first) or shapes(label) != \
                    shapes(first):
                raise AssertionError(f'{label} does not build {first}\'s '
                                     f'model: no shared step check')
            leader[label] = first
    return leader


def phase_recognition_2d(root, sets):
    """The frame-based recipes (TSN, TSM, TIN, TANet, TRN, MobileNetV2-TSM,
    OmniSource's TSN) and C3D on recognition_configs' sets: card against
    CPU for every config of RC2D_CONFIGS (the CPU's runs in a
    reference_pool; a config of RC2D_STEP_GROUPS holds its logits and
    shares its group's first's step check), the training CLI on
    RC2D_TRAIN, the test CLI on the first one's checkpoint, and the
    refusals. Each config runs its own model, batch, segments, crop and
    in_channels, float32; none launches a kernel of the port."""
    from unittest import mock
    from mscl_torch.apis import inference
    t_phase = time.perf_counter()
    root = osp.join(root, 'recognition_2d')
    os.makedirs(root)
    paths = {label: RC2D + path for label, path, _ in RC2D_CONFIGS}
    kinds = {label: kind for label, _, kind in RC2D_CONFIGS}
    leader = rc2d_step_groups(paths)
    pending = {}
    t0 = time.perf_counter()
    with reference_pool(root) as pool:
        for label, path in paths.items():
            cfg = Config.fromfile(path)
            fault = mock.patch.object(
                importlib.import_module('mscl_torch.models.backbones.' +
                                        RC2D_FAULTS[label][0]),
                RC2D_FAULTS[label][1], lambda x, *_: x) \
                if label in RC2D_FAULTS else None
            # tsn_r101_mmit's multi-class target is refused in training,
            # as the JAX Recognizer2D fails on it (ROADMAP.md Queue 3): no
            # steps; a config of a step group but its first: its logits
            steps = 0 if label == 'tsn_r101_mmit' or label in leader \
                else RC_CHECK_STEPS
            cut = depth_cut(RC2D_STEP_BLOCKS) if steps and \
                cfg.model.backbone.type in RC2D_DEPTH_CUT else None
            pending[label] = recognition_card_vs_cpu(
                pool, cfg, sets, kinds[label],
                full_width_check_cfg(cfg.model.to_dict()), RC2D_CHECK,
                steps, fault, cut)
            torch.cuda.empty_cache()
        checks = {}
        for label, finish in pending.items():
            checks[label] = finish()
            log(phase='recognition_2d_card_vs_cpu', config=paths[label],
                step_check_of=leader.get(label, label), **checks[label])
    for label, first in leader.items():
        if checks[label]['imgs'] != checks[first]['imgs']:
            raise AssertionError(f'{label}\'s clips are not {first}\'s: '
                                 f'{checks[label]["imgs"]}')
    check_s = time.perf_counter() - t0
    rows = {}
    for label, validate in RC2D_TRAIN:
        rows[label] = recognition_train(paths[label], sets, kinds[label],
                                        validate, osp.join(root, label))
        log(phase='recognition_2d_config', config=paths[label],
            **rows[label])
    label = RC2D_TRAIN[0][0]
    work = osp.join(root, label)
    loop_s, restore = timed_calls(inference, 'run_test')
    try:
        metrics, launches, test_s = cli_run(test_cli.main, [
            paths[label], osp.join(work, 'epoch_1.pth'), '--out',
            osp.join(work, 'test.json'), '--cfg-options',
            *recognition_options(sets, kinds[label], work)])
    finally:
        restore()
    if any(launches.values()) or not all(0 <= v <= 1
                                         for v in metrics.values()):
        raise AssertionError(f'test CLI: {metrics}, {launches}')
    refusals = recognition_refusals(sets, root, RC2D_NTHWC, RC2D_REFUSED)
    seconds = time.perf_counter() - t_phase
    # the TSN test pipeline: 3 clips of 1 frame, ThreeCrop: 9 views a video
    test = dict(videos=RC_VAL, views_a_video=9, metrics=metrics,
                videos_per_s=RC_VAL / test_s,
                loop_videos_per_s=RC_VAL / sum(loop_s))
    worst = {key: max(checks, key=lambda k: checks[k][key] or 0)
             for key in ('logit_share', 'own_logit_share', 'loss_share',
                         'grad_share', 'update_share')}
    cut = sum('step_imgs' in c for c in checks.values())
    log(phase='recognition_2d', test_cli=test, refusals=refusals,
        card_vs_cpu_s=check_s, seconds=seconds)
    log(phase='recognition_2d', headline=dict(
        checks=f'card_vs_cpu ({len(checks)} configs at full width: logits, '
               f'losses, gradients, updates against float64, '
               f'{len(checks) - len(leader) - 1} step checks, {cut} at '
               f'{RC2D_STEP_BLOCKS} blocks a stage; the planted '
               f'faults failed it), finite losses, 0 kernel launches, test '
               f'metrics, {len(refusals)} refusals',
        cpu_refs_s=round(sum(c['cpu_s'] for c in checks.values()), 1),
        seconds=round(seconds, 1), card_vs_cpu_s=round(check_s, 1),
        worst_card_vs_cpu={key: [k, _short(checks[k][key])]
                           for key, k in worst.items()},
        faults={label: {key: _short(v) for key, v in
                        checks[label]['fault'].items()}
                for label in RC2D_FAULTS},
        test_videos_per_s=round(test['videos_per_s'], 2),
        configs={k: [round(r['steady_ms'], 1),
                     round(r['data_wait_share'], 3),
                     round(r['device_ms'], 1),
                     round(r['idle_share'], 3),
                     round(r['peak_bytes'] / 2 ** 30, 2)]
                 for k, r in rows.items()},
        keys='steady_ms, data_wait_share, device_ms, idle_share, '
             'peak_GiB'))


def zoo_cut(frames, crop, blocks=None):
    """``recognition_card_vs_cpu``'s cut: the first ``frames`` frames of
    each clip (T is dim -3 of (..., C, T, H, W); a Recognizer2D batch
    (B, segments, C, H, W) keeps its segments) and its centre
    ``crop`` x ``crop``; for TimeSformer the step model of that clip
    (img_size, num_frames), for Swin of that crop (img_size). With
    ``blocks`` the step model is cut in depth too: Swin's stages to
    ``blocks`` (its ``depths``); with ``frames`` None the clip is kept
    and a 2D ResNet's stages cut to their first ``blocks`` blocks
    (``depth_cut``). The weights are the full model's."""
    if frames is None:
        return depth_cut(blocks)

    def cut(batch, model_cfg):
        imgs = batch['imgs']
        if imgs.ndim == 6:
            imgs = imgs[..., :frames, :, :]
        h, w = imgs.shape[-2:]
        top, left = (h - crop) // 2, (w - crop) // 2
        imgs = np.ascontiguousarray(
            imgs[..., top:top + crop, left:left + crop])
        step_cfg = None
        if model_cfg['backbone']['type'] == 'TimeSformer':
            step_cfg = json.loads(json.dumps(model_cfg))
            step_cfg['backbone'].update(img_size=crop, num_frames=frames)
        elif 'swin' in model_cfg['backbone']['type'].lower():
            step_cfg = json.loads(json.dumps(model_cfg))
            step_cfg['backbone'].update(img_size=crop)
            if blocks is not None:
                step_cfg['backbone']['depths'] = blocks
        return dict(batch, imgs=imgs), step_cfg
    return cut


def depth_cut(blocks):
    """``recognition_card_vs_cpu``'s cut in depth: the batch as it is, and
    the step model the config's with each stage of its 2D ResNet cut to
    its first ``blocks`` blocks (``_recognition_model`` cuts it after the
    build; its weights the full model's)."""
    def cut(batch, model_cfg):
        return batch, dict(model_cfg, stage_blocks_cut=blocks)
    return cut


def zoo_slowfast_ncthw(root):
    """slowfast_r50_4x16x1 derived from the shipped file, every
    FormatShape NCTHW, written as a config file under ``root``."""
    cfg = Config.fromfile(ZOO_SLOWFAST).to_dict()
    for split in ('train', 'val', 'test'):
        for step in cfg['data'][split]['pipeline']:
            if step['type'] == 'FormatShape':
                step['input_format'] = 'NCTHW'
    path = osp.join(root, 'slowfast_r50_4x16x1_ncthw.py')
    with open(path, 'w') as f:
        f.write('# slowfast_r50_4x16x1_256e_kinetics400_rgb.py, every '
                'FormatShape NCTHW\n')
        for key, value in cfg.items():
            f.write(f'{key} = {value!r}\n')
    return path


def zoo_test_refusal(root):
    """x3d_s, a test-only config, refused by the test CLI at its data (a
    video codec): its model from seed 0 saved as a checkpoint, then the
    test CLI on the file and that checkpoint."""
    from mscl_torch.core import save_checkpoint, train_state
    path, word = ZOO_TEST_REFUSED
    work = osp.join(root, 'refused_' + osp.basename(path))
    model = build_model_from_cfg(Config.fromfile(path).model.to_dict(),
                                 device='cpu')
    opt = build_optimizer(model, dict(type='SGD', lr=0.0),
                          build_lr_schedule({}, 0.0, 1, 1))
    ckpt = save_checkpoint(train_state(model, opt), work, 0)
    try:
        cli_run(test_cli.main, [path, ckpt, '--cfg-options',
                                f'work_dir={work}'])
    except NotImplementedError as e:
        if word not in str(e):
            raise
        return {path: str(e)[:60]}
    raise AssertionError(f'{path} was not refused')


def phase_recognition_3d_zoo(root, sets):
    """The 3D recognition zoo and the TPN neck on recognition_configs'
    sets: card against CPU for every config of ZOO_CONFIGS (the CPU's runs
    in a reference_pool, the step checks on the clips ZOO_CONFIGS cuts) with the
    planted faults of ZOO_FAULTS, the training CLI on tpn_tsm_r50 as
    shipped and on the NCTHW-derived slowfast_r50_4x16x1 (with validation)
    and the test CLI on its checkpoint, and the refusals. Float32; no
    kernel of the port launches."""
    from unittest import mock
    from mscl_torch.apis import inference
    t_phase = time.perf_counter()
    root = osp.join(root, 'recognition_3d_zoo')
    os.makedirs(root)
    reset_launch_counts()
    pending = {}
    t0 = time.perf_counter()
    with reference_pool(root) as pool:
        for label, path, frames_crop in ZOO_CONFIGS:
            cfg = Config.fromfile(ZOO + path)
            fault = None
            if label in ZOO_FAULTS:
                module, cls, method = ZOO_FAULTS[label]
                owner = getattr(importlib.import_module(
                    'mscl_torch.models.backbones.' + module), cls)
                real = getattr(owner, method)
                broken = (lambda self, srcs, real=real:
                          [0 * y for y in real(self, srcs)]) \
                    if method == '_laterals' else (lambda self, xt: xt)
                fault = mock.patch.object(owner, method, broken)
            pending[label] = recognition_card_vs_cpu(
                pool, cfg, sets, 'rgb',
                full_width_check_cfg(cfg.model.to_dict()),
                ZOO_CLIPS.get(label, RC2D_CHECK), RC_CHECK_STEPS, fault,
                cut=zoo_cut(*frames_crop) if frames_crop else None)
            torch.cuda.empty_cache()
        checks = {}
        for label, finish in pending.items():
            checks[label] = finish()
            log(phase='recognition_3d_zoo_card_vs_cpu', config=label,
                **checks[label])
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {}
    tsm_work = osp.join(root, 'tpn_tsm_r50')
    rows['tpn_tsm_r50'] = recognition_train(
        ZOO_TPN_TSM, sets, 'rgb', False, tsm_work,
        [f'data.train.filename_tmpl={RC_RGB_TMPL}'])
    aux = [r.get('loss_aux') for r in read_log(tsm_work)
           if r['mode'] == 'train']
    if not aux or not all(a is not None and math.isfinite(a) for a in aux):
        raise AssertionError(f'tpn_tsm_r50: loss_aux {aux}')
    rows['tpn_tsm_r50']['loss_aux'] = aux
    slowfast = zoo_slowfast_ncthw(root)
    sf_work = osp.join(root, 'slowfast_r50_4x16x1')
    rows['slowfast_r50_4x16x1'] = recognition_train(
        slowfast, sets, 'rgb', True, sf_work)
    for label in rows:
        log(phase='recognition_3d_zoo_config', config=label, **rows[label])
    loop_s, restore = timed_calls(inference, 'run_test')
    try:
        metrics, launches, test_s = cli_run(test_cli.main, [
            slowfast, osp.join(sf_work, 'epoch_1.pth'), '--out',
            osp.join(sf_work, 'test.json'), '--cfg-options',
            *recognition_options(sets, 'rgb', sf_work)])
    finally:
        restore()
    if any(launches.values()) or not all(0 <= v <= 1
                                         for v in metrics.values()):
        raise AssertionError(f'test CLI: {metrics}, {launches}')
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refusals = recognition_refusals(sets, root, ZOO_NTHWC, ())
    refusals.update(zoo_test_refusal(root))
    refusals_s = time.perf_counter() - t0
    launched = dict(l_neg=di.l_neg.launches, dq=di.dq.launches,
                    corr_lookup=cl.corr_lookup.launches)
    if any(launched.values()):
        raise AssertionError(f'recognition_3d_zoo launched {launched}')
    seconds = time.perf_counter() - t_phase
    # the SlowFast test pipeline: 1 clip of 32 frames, ThreeCrop 256
    test = dict(videos=RC_VAL, views_a_video=3, metrics=metrics,
                videos_per_s=RC_VAL / test_s,
                loop_videos_per_s=RC_VAL / sum(loop_s))
    worst = {key: max(checks, key=lambda k: checks[k][key] or 0)
             for key in ('logit_share', 'loss_share', 'grad_share',
                         'update_share')}
    log(phase='recognition_3d_zoo', test_cli=test, refusals=refusals,
        card_vs_cpu_s=check_s, cli_s=cli_s, refusals_s=refusals_s,
        seconds=seconds, launches=launched)
    log(phase='recognition_3d_zoo', headline=dict(
        checks=f'card_vs_cpu ({len(checks)} configs at full width: logits '
               f'at their own clip, losses, gradients, updates against '
               f'float64 on the cut clips; the planted faults failed it), '
               f'finite losses and loss_aux, 0 kernel launches, test '
               f'metrics, {len(refusals)} refusals',
        seconds=round(seconds, 1), card_vs_cpu_s=round(check_s, 1),
        cli_s=round(cli_s, 1), refusals_s=round(refusals_s, 1),
        cpu_refs_s=round(sum(c['cpu_s'] for c in checks.values()), 1),
        worst_card_vs_cpu={key: [k, _short(checks[k][key])]
                           for key, k in worst.items()},
        faults={label: {key: _short(v) for key, v in
                        checks[label]['fault'].items()}
                for label in ZOO_FAULTS},
        test_videos_per_s=round(test['videos_per_s'], 2),
        configs={k: [round(r['steady_ms'], 1),
                     round(r['data_wait_share'], 3),
                     round(r['device_ms'], 1),
                     round(r['idle_share'], 3),
                     round(r['peak_bytes'] / 2 ** 30, 2)]
                 for k, r in rows.items()},
        keys='steady_ms, data_wait_share, device_ms, idle_share, '
             'peak_GiB'))


def extern_faults():
    """recognition_extern's planted faults by label: Swin's shift mask all
    zeros (every shifted window attends across regions), DenseNet's
    concatenation swapped to [y, x]."""
    from unittest import mock
    from mscl_torch.models.backbones import extern_2d

    def no_mask(hp, wp, ws, shift):
        return np.zeros((hp // ws * (wp // ws), ws * ws, ws * ws), np.float32)

    def swapped(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([y, x], dim=1)
    return {'tsn_swin_base': mock.patch.object(extern_2d, '_shift_attn_mask',
                                               no_mask),
            'tsn_dense161': mock.patch.object(extern_2d.DenseLayer, 'forward',
                                              swapped)}


def _same_tree(a, b, path=''):
    """Where two nested states (dicts, lists, tensors, numbers) differ,
    bitwise."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            return [f'{path} keys']
        return [d for k in a for d in _same_tree(a[k], b[k], f'{path}.{k}')]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f'{path} length']
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _same_tree(x, y, f'{path}[{i}]')]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return [] if torch.equal(a.cpu(), b.cpu()) else [path]
    return [] if a == b else [path]


def extern_derived_run(root, sets):
    """tsn_r50_1x1x3 derived with EXTERN_DERIVED (AdamW, no decay on the
    norms by ``paramwise_cfg.custom_keys``, PreciseBN every epoch, the
    class-balanced sampler) through train_model on the card: 2 epochs of
    EXTERN_DERIVED_STEPS steps at a batch of 8 over the phase's set, then
    again resumed from its first epoch's checkpoint. Fails unless every
    loss is finite, each PreciseBN refresh moved BN running statistics
    and nothing else, and the state the resume loaded (weights, buffers,
    Adam's moments and counts, the dropout generator) is the saved one,
    bitwise. Returns the work dir, the train list and a summary."""
    from mscl_torch.apis import train_model
    prefix, train, val = sets['rgb']
    with open(train) as f:
        lines = f.read().splitlines()
    ann = osp.join(root, 'derived_train.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines[:EXTERN_DERIVED_STEPS * 8]) + '\n')
    refreshes, resumed = [], []
    real_refresh, real_resume = train_loop.precise_bn_update, \
        train_loop.Runner.resume

    def refresh(model, loader, to_device, num_iters=200):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        real_refresh(model, loader, to_device, num_iters)
        moved = [k for k, v in model.state_dict().items()
                 if not torch.equal(v, before[k])]
        refreshes.append(dict(
            moved=len(moved), iters=num_iters,
            other=[k for k in moved if not k.endswith(('running_mean',
                                                       'running_var'))]))

    def resume(self, path=None):
        real_resume(self, path)
        want, got = load_checkpoint(path), self.state()
        resumed.append(_same_tree(
            [want[k] for k in ('state_dict', 'dropout_rng', 'aug_rng')] +
            [want['optimizer']['steps'], want['optimizer']['adam']['state']],
            [got[k] for k in ('state_dict', 'dropout_rng', 'aug_rng')] +
            [got['optimizer']['steps'], got['optimizer']['adam']['state']]))

    def run(work, resume_from=None):
        cfg = Config.fromfile(EXTERN_DERIVED_BASE)
        cfg.merge_from_dict({
            'data.train.ann_file': ann, 'data.train.data_prefix': prefix,
            'data.val.ann_file': val, 'data.val.data_prefix': prefix,
            'data.test.ann_file': val, 'data.test.data_prefix': prefix,
            'data.videos_per_gpu': 8, 'checkpoint_config.interval': 1,
            'log_config.interval': 1, 'work_dir': work, **EXTERN_DERIVED})
        t0 = time.perf_counter()
        runner, _ = train_model(cfg, validate=False, seed=0,
                                resume_from=resume_from)
        torch.cuda.synchronize()
        return runner, time.perf_counter() - t0
    work = osp.join(root, 'tsn_r50_derived')
    train_loop.precise_bn_update = refresh
    train_loop.Runner.resume = resume
    try:
        runner, run_s = run(work)
        again, resume_s = run(osp.join(root, 'tsn_r50_derived_resumed'),
                              osp.join(work, 'epoch_1.pth'))
    finally:
        train_loop.precise_bn_update = real_refresh
        train_loop.Runner.resume = real_resume
    losses = [r['loss'] for r in read_log(work) if r['mode'] == 'train']
    kinds = (runner.optimizer.kind, len(runner.optimizer.opt.param_groups))
    if not losses or not all(math.isfinite(x) for x in losses) or \
            len(losses) != 2 * EXTERN_DERIVED_STEPS or \
            runner.optimizer.steps != 2 * EXTERN_DERIVED_STEPS or \
            again.optimizer.steps != 2 * EXTERN_DERIVED_STEPS or \
            kinds != ('adam', 2):
        raise AssertionError(f'derived run: losses {losses}, optimizer '
                             f'{kinds}, steps {runner.optimizer.steps}, '
                             f'{again.optimizer.steps}')
    if len(refreshes) != 3 or any(r['other'] or not r['moved']
                                  for r in refreshes):
        raise AssertionError(f'PreciseBN: {refreshes}')
    if resumed != [[]]:
        raise AssertionError(f'the resume loaded another state: {resumed}')
    del runner, again
    torch.cuda.empty_cache()
    return work, dict(losses=losses, run_s=run_s, resume_s=resume_s,
                      precise_bn=refreshes, optimizer=kinds,
                      resumed_bitwise=True)


def extern_tools(root, work):
    """The analysis and deployment tools on the derived run's outputs:
    analyze_logs on its log, publish_model on its last checkpoint, get_flops
    and benchmark on its config at a batch of 1 and 8 clips of 3 segments
    at 224x224, export of its last checkpoint with --verify (the program
    reloaded and run on the card against the eager model)."""
    from mscl_torch.tools import (analyze_logs, benchmark, export, get_flops,
                                  publish_model)
    ckpt = osp.join(work, 'epoch_2.pth')
    timing = analyze_logs.main(['cal_train_time',
                                osp.join(work, 'log.json')])
    published = publish_model.main([ckpt, osp.join(root, 'tsn_r50.pth')])
    flops = get_flops.main([EXTERN_DERIVED_BASE, '--shape', '1', '3',
                            '3', '224', '224'])
    bench = benchmark.main([EXTERN_DERIVED_BASE, '--shape', '8', '3', '3',
                            '224', '224', '--iterations', '20',
                            '--log-interval', '20'])
    t0 = time.perf_counter()
    exported = export.main([EXTERN_DERIVED_BASE, ckpt, '--output-file',
                            osp.join(root, 'tsn_r50.pt2'), '--shape',
                            '1', '3', '3', '224', '224', '--verify'])
    export_s = time.perf_counter() - t0
    published_ckpt = load_checkpoint(published)
    if published_ckpt['optimizer'] is not None or \
            _same_tree(published_ckpt['state_dict'],
                       load_checkpoint(ckpt)['state_dict']) or \
            not re.search(r'-[0-9a-f]{8}\.pth$', published) or \
            bench['device'] != 'cuda:0' or not timing or \
            not exported['max_abs_err'] < 1e-4:
        raise AssertionError(f'tools: {published}, {bench["device"]}, '
                             f'{timing}, {exported}')
    return dict(cal_train_time={k: float(v) for k, v in
                                list(timing.values())[0].items()},
                published=osp.basename(published),
                params=flops['params'], gflops=flops['flops'] / 1e9,
                benchmark_videos_per_s=bench['videos_per_s'],
                benchmark_ms=float(np.mean(bench['times'])) * 1e3,
                export_bytes=exported['bytes'],
                export_max_abs_err=exported['max_abs_err'],
                export_s=export_s)


def phase_recognition_extern(root, sets):
    """The external-name 2D backbones and the runtime of Queue 1 item 3 on
    recognition_configs' sets: card against CPU for EXTERN_CONFIGS at full
    width (the CPU's runs in the phase's reference_pool) with the planted
    faults of ``extern_faults``, which must fail it; the training CLI on TSN
    over Swin-B (RC_STEPS steps at a batch of 8, validation) and the test
    CLI on its checkpoint; ``extern_derived_run`` and ``extern_tools``.
    Float32; no kernel of the port launches."""
    from mscl_torch.apis import inference
    t_phase = time.perf_counter()
    root = osp.join(root, 'recognition_extern')
    os.makedirs(root)
    reset_launch_counts()
    faults = extern_faults()
    pending = {}
    t0 = time.perf_counter()
    with reference_pool(root) as pool:
        for label, path, frames_crop in EXTERN_CONFIGS:
            cfg = Config.fromfile(EXTERN + path)
            pending[label] = recognition_card_vs_cpu(
                pool, cfg, sets, 'rgb',
                full_width_check_cfg(cfg.model.to_dict()), RC2D_CHECK,
                RC_CHECK_STEPS, faults.get(label),
                cut=zoo_cut(*frames_crop) if frames_crop else None)
            torch.cuda.empty_cache()
        checks = {}
        for label, finish in pending.items():
            checks[label] = finish()
            log(phase='recognition_extern_card_vs_cpu', config=label,
                **checks[label])
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    swin = EXTERN + EXTERN_CONFIGS[0][1]
    work = osp.join(root, 'tsn_swin_base')
    row = recognition_train(swin, sets, 'rgb', True, work)
    log(phase='recognition_extern_config', config=swin, **row)
    loop_s, restore = timed_calls(inference, 'run_test')
    try:
        metrics, launches, test_s = cli_run(test_cli.main, [
            swin, osp.join(work, 'epoch_1.pth'), '--out',
            osp.join(work, 'test.json'), '--cfg-options',
            *recognition_options(sets, 'rgb', work)])
    finally:
        restore()
    if any(launches.values()) or not all(0 <= v <= 1
                                         for v in metrics.values()):
        raise AssertionError(f'test CLI: {metrics}, {launches}')
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    derived_work, derived = extern_derived_run(root, sets)
    derived_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools = extern_tools(root, derived_work)
    tools_s = time.perf_counter() - t0
    launched = dict(l_neg=di.l_neg.launches, dq=di.dq.launches,
                    corr_lookup=cl.corr_lookup.launches)
    if any(launched.values()):
        raise AssertionError(f'recognition_extern launched {launched}')
    seconds = time.perf_counter() - t_phase
    # the TSN test pipeline: 3 clips of 1 frame, ThreeCrop: 9 views a video
    test = dict(videos=RC_VAL, views_a_video=9, metrics=metrics,
                videos_per_s=RC_VAL / test_s,
                loop_videos_per_s=RC_VAL / sum(loop_s))
    worst = {key: max(checks, key=lambda k: checks[k][key] or 0)
             for key in ('logit_share', 'loss_share', 'grad_share',
                         'update_share')}
    log(phase='recognition_extern', test_cli=test, derived=derived,
        tools=tools, card_vs_cpu_s=check_s, cli_s=cli_s,
        derived_s=derived_s, tools_s=tools_s, seconds=seconds,
        launches=launched)
    log(phase='recognition_extern', headline=dict(
        checks=f'card_vs_cpu ({len(checks)} configs at full width: logits, '
               f'losses, gradients, updates against float64; the planted '
               f'faults failed it), finite losses, 0 kernel launches, test '
               f'metrics; the derived tsn_r50 run (AdamW, custom_keys, '
               f'PreciseBN moved the BN statistics alone, the class-balanced '
               f'sampler) resumed bitwise; its exported program within '
               f'{_short(tools["export_max_abs_err"])} of the eager model',
        seconds=round(seconds, 1), card_vs_cpu_s=round(check_s, 1),
        cli_s=round(cli_s, 1), derived_s=round(derived_s, 1),
        tools_s=round(tools_s, 1),
        cpu_refs_s=round(sum(c['cpu_s'] for c in checks.values()), 1),
        cpu_float64_s={k: round(c['cpu_float64_s'], 1)
                       for k, c in checks.items()},
        worst_card_vs_cpu={key: [k, _short(checks[k][key])]
                           for key, k in worst.items()},
        faults={label: {key: _short(v) for key, v in
                        checks[label]['fault'].items()}
                for label in faults},
        test_videos_per_s=round(test['videos_per_s'], 2),
        swin_cli=[round(row['steady_ms'], 1),
                  round(row['data_wait_share'], 3),
                  round(row['device_ms'], 1), round(row['idle_share'], 3),
                  round(row['peak_bytes'] / 2 ** 30, 2)],
        keys='steady_ms, data_wait_share, device_ms, idle_share, peak_GiB',
        derived_losses=[round(x, 4) for x in derived['losses']],
        tools={k: _short(v) for k, v in tools.items()
               if k != 'cal_train_time'}))


def extern_step_costs(root, sets):
    """The measurement behind EXTERN_CONFIGS' cuts, not part of the smoke
    run: each config's CPU float64 train step on its own clip, in a
    reference_pool with every worker busy, as the checks run (a config
    whose step takes over ZOO_STEP_S is cut). Logs ``extern_step_cost``
    lines. On the card: python3 -c "import os.path as osp, tempfile,
    chip_smoke as c; r = osp.join(tempfile.mkdtemp(), 'recognition');
    c.extern_step_costs(r, c.write_recognition_sets(r))"."""
    os.makedirs(root, exist_ok=True)
    with reference_pool(root) as pool:
        pending = {}
        for label, path, _ in EXTERN_CONFIGS:
            cfg = Config.fromfile(EXTERN + path)
            pending[label] = pool.submit(_float64_step_seconds, dict(
                cfg=cfg.filename,
                model_cfg=full_width_check_cfg(cfg.model.to_dict()),
                batch=_recognition_batch(cfg, sets, 'rgb', RC2D_CHECK)))
        out = {}
        for label, future in pending.items():
            out[label] = future.result()
            log(phase='extern_step_cost', config=label,
                own_clip_float64_s=out[label], cut=out[label] > ZOO_STEP_S)
    return out


def _float64_step_seconds(task):
    """A reference_pool worker's float64 train step of a config's model
    on its own clip (``_recognition_run``): its seconds."""
    t0 = time.perf_counter()
    _recognition_run(task['model_cfg'], Config.fromfile(task['cfg']),
                     task['batch'], 'cpu', 1, dtype=torch.float64,
                     logits=False)
    return time.perf_counter() - t0


def zoo_step_costs(root, sets):
    """The measurement behind ZOO_CONFIGS' cuts, not part of the smoke
    run: each config's CPU float64 train step on its own (uncut) clip, in
    a reference_pool with every worker busy, as recognition_3d_zoo's
    checks run; a config whose step takes over ZOO_STEP_S is cut. Then
    for ZOO_WITNESS (config, parameter) on one clip, its own and cut: the
    card's float64 gradients against the CPU's float64, and the card's
    float32 check at the own clip (ZOO_CLIPS' note). Logs
    ``zoo_step_cost`` lines. On the
    card: python3 -c "import os.path as osp, tempfile, chip_smoke as c;
    r = osp.join(tempfile.mkdtemp(), 'recognition');
    c.zoo_step_costs(r, c.write_recognition_sets(r))"."""
    os.makedirs(root, exist_ok=True)
    cfgs = {label: Config.fromfile(ZOO + path)
            for label, path, _ in ZOO_CONFIGS}
    models = {label: full_width_check_cfg(cfg.model.to_dict())
              for label, cfg in cfgs.items()}
    with reference_pool(root) as pool:
        pending = {label: pool.submit(_float64_step_seconds, dict(
            cfg=cfg.filename, model_cfg=models[label],
            batch=_recognition_batch(cfg, sets, 'rgb', RC2D_CHECK)))
            for label, cfg in cfgs.items()}
        for label, future in pending.items():
            seconds = future.result()
            log(phase='zoo_step_cost', config=label,
                own_clip_float64_s=seconds, cut=seconds > ZOO_STEP_S)
        label, leaf = ZOO_WITNESS
        cfg, frames_crop = cfgs[label], dict(
            (c[0], c[2]) for c in ZOO_CONFIGS)[label]
        batch = _recognition_batch(cfg, sets, 'rgb', RC2D_CHECK)
        for clip, (step_batch, step_cfg) in (
                ('own', (batch, None)),
                ('cut', zoo_cut(*frames_crop)(batch, models[label]))):
            card, cpu = (_recognition_run(
                models[label], cfg, batch, dev, 1, dtype=torch.float64,
                logits=False, step_batch=step_batch, step_cfg=step_cfg)
                for dev in ('cuda', 'cpu'))
            rel = _rel_errors(card['grads'], cpu['grads'])
            worst = max(rel, key=rel.get)
            log(phase='zoo_step_cost', witness=label, clip=clip,
                imgs=list(step_batch['imgs'].shape), leaf=leaf,
                card64_rel=rel[leaf], worst=worst, worst_rel=rel[worst])
        try:
            check = recognition_card_vs_cpu(
                pool, cfg, sets, 'rgb', models[label], RC2D_CHECK,
                RC_CHECK_STEPS)()
        except AssertionError as e:
            check = dict(failed=str(e))
        log(phase='zoo_step_cost', witness=label, clip='own',
            float32_check=check)


def phase_pretrain_configs(dev, root, pkls):
    """Every pretrain config the repo ships: full-width steps of each
    config's own model; card against CPU for MoCo with each of its augs
    and for MSCL with r50 towers, narrowed; the CLI on mscl_r50 (with an
    exact resume) and moco_r18."""
    rows = [config_steps(dev, name) for name in PRETRAIN_CONFIGS]
    rng = np.random.default_rng(12)
    moco_batches = [{'imgs': [rng.uniform(size=(4, 3, 8, 32, 32))
                              .astype(np.float32) for _ in range(2)]}
                    for _ in range(2)]
    for name in PRETRAIN_CONFIGS:
        if name.startswith('moco_r18'):
            card_vs_cpu(narrow_moco_r18_cfg(name), moco_batches, name)
    card_vs_cpu(narrow_mscl_r50_cfg(),
                [flagship_batch(4, hw=64, seed=s) for s in (13, 14)],
                'mscl_r50_cosm_lr3e-2')
    return rows, configs_cli(root, pkls)


def phase_recognizer3d_card_vs_cpu():
    """Two train steps of a narrow Recognizer3D (r3d_18 8 wide, I3DHead 10
    classes, dropout 0) on the card and on the CPU from the same weights
    and batches, SGD under the step policy with the clip acting, then
    forward_test."""
    cfg = dict(type='Recognizer3D',
               backbone=dict(type='torchvision.r3d_18', base_width=8),
               cls_head=dict(type='I3DHead', num_classes=10, in_channels=64,
                             spatial_type='none', dropout_ratio=0.0),
               test_cfg=dict(average_clips='prob'))
    rng = np.random.default_rng(4)
    batches = [dict(imgs=rng.normal(size=(4, 1, 3, 4, 32, 32)).astype(
        np.float32), label=rng.integers(0, 10, 4)) for _ in range(2)]
    test_imgs = rng.normal(size=(4, 2, 3, 4, 32, 32)).astype(np.float32)
    logs, scores = {}, {}
    for dev in ('cpu', 'cuda'):
        model = build_model_from_cfg(cfg, device=dev, seed=1)
        opt = build_optimizer(
            model, dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-6),
            build_lr_schedule(dict(policy='step', step=[1]), 0.1, 2, 1),
            grad_clip=dict(max_norm=0.5))
        step = make_train_step(model, opt)
        logs[dev] = [{k: v.item() for k, v in step(to_torch(b, dev)).items()}
                     for b in batches]
        model.eval()
        with torch.no_grad():
            scores[dev] = model.forward_test(
                torch.from_numpy(test_imgs).to(dev)).cpu()
    worst = 0.0
    for cpu, card in zip(logs['cpu'], logs['cuda']):
        torch.testing.assert_close(torch.tensor(card['loss_cls']),
                                   torch.tensor(cpu['loss_cls']), **STEP_TOL)
        worst = max(worst, abs(card['loss_cls'] - cpu['loss_cls']))
    torch.testing.assert_close(scores['cuda'], scores['cpu'], **STEP_TOL)
    log(phase='card_vs_cpu', model='Recognizer3D', steps=2,
        max_abs_loss_diff=worst,
        max_abs_score_diff=(scores['cuda'] - scores['cpu']).abs().max()
        .item(), **{f'loss_step{i + 1}': v['loss'] for i, v in
                    enumerate(logs['cuda'])})


# ------------------------------------------------------------ ablation arms
def abl_batches(arm, b=16, seed=0):
    """Two of the ablation tool's tiny-scale batches (its host draws)."""
    data = abl_tool.make_videos(8, 32, 4, seed=100)
    train_idx = np.arange(len(data['labels']))[::2]
    rng = np.random.default_rng(seed)
    return [abl_tool.make_batch(rng, data, train_idx, arm, b, 4)
            for _ in range(2)]


def abl_card_vs_cpu_cases():
    """(name, model config, batches): each arm at the tool's tiny scale,
    the full arm with ShuffleBN (4 groups), with its flow passes as one
    forward and under two flow keys, and the narrow flagship whose RGB
    neck has TemporalModulation, reverse_st and SEPC's iBN."""
    def tiny(arm):
        return abl_tool.arm_cfg(arm, 'tiny', 4, 256, 300, 16, 32)
    cases = [(arm, tiny(arm), abl_batches(arm)) for arm in abl_tool.ARMS]
    shuffle = tiny('mscl')
    for tower in ('recognizer', 'recognizer_flow'):
        shuffle[tower] = dict(shuffle[tower], shuffle_bn=4)
    cases.append(('mscl+shuffle_bn4', shuffle, abl_batches('mscl')))
    cases.append(('mscl+batch_flow_passes',
                  dict(tiny('mscl'), batch_flow_passes=True),
                  abl_batches('mscl')))
    keys = ['flow_imgs', 'rot_flow_imgs']
    two = []
    for batch in abl_batches('mscl'):
        flows = batch.pop('flow_imgs')
        two.append(dict(batch, **{keys[0]: [f[:, :, :4] for f in flows],
                                  keys[1]: [f[:, :, 4:] for f in flows]}))
    cases.append(('mscl+two_flow_keys', dict(tiny('mscl'), flow_key=keys),
                  two))
    tpn = narrow_flagship_cfg(K=64, dim=32, rgb_width=16, flow_width=4,
                              aug=dict(FLAGSHIP_AUG, crop_size=32))
    tpn['recognizer'] = dict(tpn['recognizer'], neck=dict(
        tpn['recognizer']['neck'], reverse_st=True,
        temporal_modulation_cfg=dict(downsample_scales=(3, 3, 3)),
        sepc_cfg=dict(tpn['recognizer']['neck']['sepc_cfg'], iBN=True)))
    cases.append(('tpn_tm_reverse_st_ibn', tpn,
                  [flagship_batch(4, hw=32, seed=s) for s in (15, 16)]))
    return cases


def abl_tool_run(arm, out_dir):
    """The ablation tool's main at full scale for ABL_STEPS steps, one
    step (ABL_PROFILED) profiled: its record, step times and losses,
    launches, peak memory and the profiled step's summary."""
    from torch.profiler import ProfilerActivity
    step_s, losses, prof = [], [], {}

    def on_step(s, seconds, loss):
        step_s.append(seconds)
        losses.append(loss)
        if s == ABL_PROFILED - 1:
            prof['p'] = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof['p'].__enter__()
            prof['t0'] = time.perf_counter()
        elif s == ABL_PROFILED:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - prof['t0']) * 1e3
            prof['p'].__exit__(None, None, None)
            prof['summary'] = profile_summary(f'ablation_{arm}', prof['p'],
                                              wall_ms)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    record = abl_tool.main(['--arm', arm, '--scale', 'full', '--steps',
                            str(ABL_STEPS), '--out-dir', out_dir],
                           on_step=on_step)
    seconds = time.perf_counter() - t0
    return dict(record=record, step_s=step_s, losses=losses,
                launches=dict(l_neg=di.l_neg.launches, dq=di.dq.launches),
                peak_bytes=torch.cuda.max_memory_allocated(),
                profiled=prof['summary'], seconds=seconds)


def abl_check_record(arm, run, out_dir):
    """The tool's JSON (written and returned) has the JAX tool's keys and
    finite metrics in [0, 1]; every step's loss is finite; each kernel
    launched ABL_LAUNCHES[arm] times a step."""
    record = run['record']
    with open(osp.join(out_dir, f'{arm}_full_s0.json')) as f:
        written = json.load(f)
    if set(written) != ABL_JSON_KEYS or set(record) != ABL_JSON_KEYS:
        raise AssertionError(f'{arm}: JSON keys {sorted(written)}')
    for when in ('init', 'final'):
        m = written[when]
        vals = [m['motion']['R@1'], m['motion']['R@5'], m['probe_acc'],
                m['instance_R1']]
        if not all(0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f'{arm} {when} metrics {m}')
    if len(run['losses']) != ABL_STEPS or \
            not all(math.isfinite(v) for v in run['losses']):
        raise AssertionError(f'{arm}: losses {run["losses"]}')
    want = ABL_LAUNCHES[arm] * ABL_STEPS
    if run['launches'] != dict(l_neg=want, dq=want):
        raise AssertionError(f'{arm}: launches {run["launches"]}, want '
                             f'{want} each')


def abl_dp_steps(ref_path=None):
    """Two steps of the narrow flagship model with ShuffleBN (4 groups) in
    both towers and SyncMoCoAugmentV5, on this rank's rows of two global
    batches of 8 (all of them with no group). Returns the states and logs,
    or with ref_path (world 1's) each step's comparison against it, and
    the collectives."""
    dev = torch.device('cuda', torch.cuda.current_device())
    cfg = narrow_flagship_cfg(aug=dict(FLAGSHIP_AUG, crop_size=32))
    for tower in ('recognizer', 'recognizer_flow'):
        cfg[tower] = dict(cfg[tower], shuffle_bn=4)
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    opt = build_optimizer(
        model, dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4),
        build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.02,
                          400, 100),
        grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    dist.reset_counts()
    states, logs = [], []
    for seed in (17, 18):
        batch = dp_rows(flagship_batch(8, hw=32, seed=seed))
        logs.append({k: v.item() for k, v in
                     step(to_torch(batch, dev)).items()})
        states.append({k: v.detach().to('cpu', copy=True)
                       for k, v in model.state_dict().items()})
    out = dict(collectives=dist.counts(), logs=logs)
    if ref_path is None:
        out['states'] = states
    else:
        ref = torch.load(ref_path, weights_only=True)
        out['compare'] = [dp_compare(st, lv, rs, rl) for st, lv, rs, rl in
                          zip(states, logs, ref['states'], ref['logs'])]
        out['digest'] = state_digest(states[-1])
    return out


def abl_shufflebn(root):
    """shufflebn_ab through its main on the card; then ShuffleBN at world
    2 (two gloo ranks sharing the card) against no group, within
    DP_TOL."""
    path = osp.join(root, 'shufflebn_ab.json')
    reset_launch_counts()
    t0 = time.perf_counter()
    ab = sbn_tool.main(['--steps', str(ABL_AB_STEPS), '--out', path])
    ab_s = time.perf_counter() - t0
    want = 2 * ABL_AB_STEPS
    launches = dict(l_neg=di.l_neg.launches, dq=di.dq.launches)
    if launches != dict(l_neg=want, dq=want):
        raise AssertionError(f'shufflebn_ab: launches {launches}')
    for name in ('global_bn', 'shuffle_bn4'):
        r = ab[name]
        if len(r['losses']) != ABL_AB_STEPS or not all(
                math.isfinite(v) for v in r['losses']) or \
                not 0 <= r['R@1'] <= r['R@5'] <= 1:
            raise AssertionError(f'shufflebn_ab {name}: {r}')
    ref_path = osp.join(root, 'abl_dp_world1.pth')
    ref = abl_dp_steps()
    torch.save(dict(states=ref['states'], logs=ref['logs']), ref_path)
    ranks = dist.spawn(abl_dp_steps, 2, (ref_path,), backend='gloo',
                       device='cuda', join_timeout_s=600)
    worst = {}
    for r in ranks:
        for i, (errs, shares, misses) in enumerate(r['compare']):
            bad = {g: m for g, m in misses.items() if m}
            if bad:
                raise AssertionError(f'ShuffleBN world 2 step {i + 1}: '
                                     f'{bad}')
            for g, v in shares.items():
                worst[g] = max(worst.get(g, 0.0), v)
        if r['collectives'].get('shuffle_bn', {}).get('calls') != 2 * 3:
            raise AssertionError(f'ShuffleBN gathers {r["collectives"]}')
    if ranks[0]['digest'] != ranks[1]['digest']:
        raise AssertionError('ShuffleBN world 2: the ranks differ')
    log(phase='shufflebn_ab', steps=ABL_AB_STEPS, seconds=ab_s,
        launches=launches,
        **{f'{n}_{k}': ab[n][k] for n in ab for k in ('R@1', 'R@5')},
        final_loss={n: ab[n]['losses'][-1] for n in ab},
        world2_worst_share_of_tol=worst,
        world2_collectives=ranks[0]['collectives'])


def phase_ablation_arms(dev, root):
    """The MSCL ablation family: the decayed-InfoNCE pair at the ablation
    tool's shapes (kernel_ablation lines); card against CPU for each arm
    (tiny scale) and option; the tool's main at full scale for every arm
    (ablation_arm lines); the ShuffleBN A/B and ShuffleBN at world 2."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for b, c, k in ABL_KERNEL_SHAPES:
        for row in kernel_rows(*kernel_inputs(dev, b, c, k), flush):
            row['launches_per_step'] = ABL_LAUNCHES
            log(phase='kernel_ablation', **row)
            rows.append(row)
    del flush
    for name, cfg, batches in abl_card_vs_cpu_cases():
        card_vs_cpu(cfg, batches, name)
    out_dir = osp.join(root, 'ablation')
    arms = {}
    for arm in abl_tool.ARMS:
        run = abl_tool_run(arm, out_dir)
        abl_check_record(arm, run, out_dir)
        steady = [t for i, t in enumerate(run['step_s'])
                  if i not in (0, ABL_PROFILED)]
        arms[arm] = dict(
            steps=ABL_STEPS, step_ms=[t * 1e3 for t in run['step_s']],
            steady_ms=1e3 * sum(steady) / len(steady),
            device_busy_ms=run['profiled']['device_busy_ms'],
            device_idle_share=run['profiled']['device_idle_share'],
            profiled_wall_ms=run['profiled']['wall_ms'],
            peak_bytes=run['peak_bytes'], launches=run['launches'],
            seconds=run['seconds'], losses=run['losses'],
            init=run['record']['init'], final=run['record']['final'])
        log(phase='ablation_arm', arm=arm, **arms[arm])
    abl_shufflebn(root)
    return rows, arms


def mf_flagship_cli(root, pkls):
    """(a) The flagship config with MSCLWithAugMSFMxHead through the
    training CLI at full width (float32, K=65536, V5, batch 32): 1 epoch
    of MF_STEPS steps over pretrain_cli's videos, thread workers, then one
    more step profiled on a batch already on the card. Fails unless every
    logged loss (the four MSF terms among them) is finite, queue_ptr, iters
    and each tower's count are those of MF_STEPS enqueues and the kernels
    launched MF_LAUNCHES a step."""
    with open(pkls[0], 'rb') as f:
        annos = pickle.load(f)
    bs = load_flagship_config().data['videos_per_gpu']
    pkl = osp.join(root, 'mscl_family_train.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(annos[:MF_STEPS * bs], f)
    work = osp.join(root, 'work_mscl_family')
    argv = [FLAGSHIP_CONFIG, '--seed', '0', '--cfg-options',
            f'data.train.pkl_path={pkl}', 'total_epochs=1',
            'log_config.interval=1', f'work_dir={work}', *MF_OPTIONS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (runner, model), launches, run_s = cli_run(train_cli.main, argv)
    peak = torch.cuda.max_memory_allocated()
    per_epoch = len(runner.train_loader)
    head = type(model.moco_mx_head).__name__
    want = {k: v * per_epoch for k, v in MF_LAUNCHES.items()}
    if head != 'MSCLWithAugMSFMxHead' or per_epoch != MF_STEPS or \
            launches != want:
        raise AssertionError(f'{head}, {per_epoch} steps, launches '
                             f'{launches} != {want}')
    train = [r for r in read_log(work) if r['mode'] == 'train']
    bad = [r for r in train if not all(
        math.isfinite(v) for k, v in r.items() if k.startswith('loss'))]
    missing = [k for k in MF_LOSSES if not all(k in r for r in train)]
    if bad or missing or len(train) != per_epoch:
        raise AssertionError(f'{len(train)} train lines, missing {missing}, '
                             f'non-finite in {bad}')
    state, problems = {}, []
    for prefix, tower in towers(model):
        for n in ('queue_ptr', 'iters'):
            state[f'{prefix}.{n}'] = int(getattr(tower, n))
        # each step enqueues bs keys once: a column's count is the steps
        # since it was written (MF_STEPS for the never-written ones)
        cols = torch.arange(tower.K, device=tower.count.device)
        want_count = torch.where(cols < per_epoch * bs,
                                 per_epoch - cols // bs, per_epoch)
        if not torch.equal(tower.count.long(), want_count):
            problems.append(f'{prefix}.count')
        written = tower.queue[:, :per_epoch * bs].norm(dim=0)
        if not torch.allclose(written, torch.ones_like(written), atol=1e-4):
            problems.append(f'{prefix}.queue')
    want_state = moco_state(1, per_epoch, bs)
    if state != want_state or problems:
        raise AssertionError(f'moco state {state} != {want_state}, '
                             f'{problems}')
    it = iter(runner.train_loader)
    batch = to_torch(next(it), 'cuda')
    it.close()
    it._thread.join()               # no decode thread beside the step
    prof = profile('mscl_family_step', lambda: runner._train_step(batch))
    del runner, model, batch
    torch.cuda.empty_cache()
    steps_ms = [r['time'] * 1e3 for r in train]
    row = dict(config=osp.relpath(FLAGSHIP_CONFIG), options=MF_OPTIONS,
               batch=bs, K=K, steps=per_epoch, launches=launches,
               launches_a_step=MF_LAUNCHES, state=state, step_ms=steps_ms,
               data_ms=[r['data_time'] * 1e3 for r in train],
               # the epoch's last step runs after the producer has made
               # its last batch: the step alone, with no decode beside it
               last_ms=steps_ms[-1],
               device_busy_ms=prof['device_busy_ms'],
               device_idle_share=prof['device_idle_share'],
               profiled_wall_ms=prof['wall_ms'], peak_bytes=peak,
               run_s=run_s, losses=[{k: r[k] for k in MF_LOSSES + ('loss',)}
                                    for r in train])
    log(phase='mscl_family_cli', **row)
    return row


def mf_head_inputs(dev, seed):
    """Unit queries and keys (B, C) and two banks of K = MF_HEAD_K unit
    columns with decay 0.99**count, on dev, from one seed."""
    gen = torch.Generator().manual_seed(seed)

    def unit(*shape, dim):
        x = torch.randn(*shape, generator=gen)
        return (x / x.norm(dim=dim, keepdim=True)).to(dev)
    feats = [unit(B, C, dim=1) for _ in range(4)]
    banks = [(unit(C, MF_HEAD_K, dim=0), (0.99 ** torch.randint(
        0, 300, (MF_HEAD_K,), generator=gen).float()).to(dev))
        for _ in range(2)]
    return feats, banks


def mf_head_run(cfg, dev, seed):
    """A head of moco_head_v3.py on dev: its outputs, its losses and the
    gradients of their sum in the queries, on the host."""
    from mscl_torch.models import HEADS
    head = HEADS.build(dict(cfg))
    (q, k, q_flow, k_flow), (bank, bank_flow) = mf_head_inputs(dev, seed)
    q.requires_grad_(True)
    q_flow.requires_grad_(True)
    if hasattr(head, 'forward_moco_mx'):
        out = head.forward_moco_mx(q, k, q_flow, k_flow, bank, bank_flow)
        extra = out[3] if len(out) == 4 else {}
        losses = head.loss(*out[:3], **extra)
        flat = [x for o in out[:2] for x in (o if isinstance(o, tuple)
                                            else (o,))]
    else:
        labels = torch.arange(MF_HEAD_K, device=dev) % 7
        out = head(q, k, bank, label=labels[:B], label_queue=labels)
        losses = head.loss(**out)
        flat = [v for v in out.values() if v.is_floating_point()]
    sum(v for n, v in losses.items() if n.startswith('loss')).backward()
    grads = [q.grad] + ([q_flow.grad] if q_flow.grad is not None else [])
    return [x.detach().cpu() for x in flat + grads], \
        {n: v.detach().cpu() for n, v in losses.items()}


MF_HEADS = (
    ('MoCoHeadV2', dict(type='MoCoHeadV2')),
    ('MSFHead', dict(type='MSFHead', topk=5)),
    ('NMSFHead', dict(type='NMSFHead', topk=5)),
    ('NMSFHead/circle', dict(type='NMSFHead', topk=5, loss_cls=dict(
        type='MultiPositiveCircleLoss'))),
    ('MSCLWithAugMSFMxHead', dict(type='MSCLWithAugMSFMxHead', topk=5)),
    ('MSCLWithAugMSFMxHead/other_kn', dict(type='MSCLWithAugMSFMxHead',
                                           topk=5, same_kn=False)),
    ('MSCLWithAugDistillMxHead', dict(type='MSCLWithAugDistillMxHead')),
    ('MSCLWithAugDistillMxHead/small_p', dict(
        type='MSCLWithAugDistillMxHead', small_p=512)),
)


def mf_reid_run(name, cfg, dev):
    """A head of reid_distill_heads.py (or the triplet and circle losses)
    on dev from seeded weights and inputs: its outputs, losses and the
    gradients in its inputs and parameters, on the host, in train mode
    (the BN-neck's running statistics after the step included)."""
    from mscl_torch.models import HEADS, LOSSES
    torch.manual_seed(3)
    gen = torch.Generator().manual_seed(4)
    if name.startswith('MultiPositive') or name == 'TripletLoss':
        x = [torch.randn(8, 2, 16, generator=gen), torch.randn(
            8, 2, 96, generator=gen)] if name != 'TripletLoss' else \
            [torch.randn(16, 128, generator=gen)]
        x = [v.to(dev).requires_grad_(True) for v in x]
        if name == 'TripletLoss':
            x.append((torch.arange(16) % 5).to(dev))
        loss = LOSSES.build(dict(cfg))(*x)
        loss.backward()
        return [loss.detach().cpu()] + [v.grad.cpu() for v in x
                                        if v.is_floating_point()]
    head = HEADS.build(dict(cfg))
    head.init_weights(torch.Generator().manual_seed(5))
    head.to(dev).train()
    labels = (torch.arange(8) % 6).to(dev)
    if name == 'RcMoDistHead':
        levels = [torch.randn(2, 128, 4, s, s, generator=gen).to(dev)
                  .requires_grad_(True) for s in (28, 14, 7)]
        flow = torch.rand(2, 3, 8, 112, 112, generator=gen).to(dev)
        loss = head.loss_mx(**head(levels, flow))['loss_rc']
        outs, inputs = [loss], levels
    else:
        x = torch.randn(8 * 8, 512, 7, 7, generator=gen).to(dev) \
            .requires_grad_(True)
        if name == 'TSMHead3D':
            score = head(x)
            losses = head.loss(score, labels)
            outs = [score]
        else:
            score, feat = head(x, labels=labels, return_feat=True)
            losses = head.loss(score, labels, reid_feat=feat)
            outs = [score, feat]
        loss = sum(v for n, v in losses.items() if n.startswith('loss'))
        outs.append(loss)
        inputs = [x]
    loss.backward()
    return [o.detach().cpu() for o in outs] + \
        [v.grad.cpu() for v in inputs] + \
        [p.grad.cpu() for p in head.parameters() if p.grad is not None] + \
        [b.cpu() for b in head.buffers()]


MF_REID = (
    ('MultiPositiveSumLoss', dict(type='MultiPositiveSumLoss')),
    ('MultiPositiveUniLoss', dict(type='MultiPositiveUniLoss', gamma=4)),
    ('MultiPositiveCircleLoss', dict(type='MultiPositiveCircleLoss',
                                     avg_on_group=False)),
    ('TripletLoss', dict(type='TripletLoss')),
    ('TSMReidSimpleHead', dict(type='TSMReidSimpleHead', num_classes=6,
                               in_channels=512, dropout_ratio=0.0,
                               use_cosface=dict(use=True))),
    ('FGTSMReidSimpleHead', dict(type='FGTSMReidSimpleHead', num_classes=6,
                                 in_channels=512, dropout_ratio=0.0)),
    ('TSMHead3D', dict(type='TSMHead3D', num_classes=6, in_channels=512,
                       num_clfs=2, dropout_ratio=0.0)),
    ('RcMoDistHead', dict(type='RcMoDistHead', dim_fpn=128)),
)


def mf_two_r5_cfg():
    """A MoCo tower on ResNet3dSlowOnly_TwoR5 (depth 18, 8 wide, one block
    a stage; the last stage and the one before out) and BaseMoCo_TwoR5."""
    return dict(type='MoCo', backbone=dict(
        type='ResNet3dSlowOnly_TwoR5', depth=18, base_channels=8,
        stage_blocks=(1, 1, 1, 1), out_indices=(2, 3)),
        neck=dict(type='BaseMoCo_TwoR5'), dim_in=64, K=32, dim=32,
        moco_head=dict(type='MoCoHead'), aug=dict(type='IdentityAug'))


def mf_card_vs_cpu(dev):
    """(b) Every head and loss of the slice on the card against the CPU on
    the same inputs and weights within STEP_TOL (the heads' products in the
    decayed-InfoNCE kernels on the card, plain on the CPU); the narrow
    MSCLWithAug with the MSF head and the TwoR5 MoCo tower, two train
    steps each, as card_vs_cpu. Returns the worst difference of each."""
    worst = {}
    for name, cfg in MF_HEADS:
        (cpu, cpu_losses), (card, card_losses) = (
            mf_head_run(cfg, d, 11) for d in ('cpu', dev))
        if sorted(cpu_losses) != sorted(card_losses):
            raise AssertionError(f'{name}: {sorted(card_losses)}')
        for a, b in zip(card + list(card_losses.values()),
                        cpu + list(cpu_losses.values())):
            torch.testing.assert_close(a, b, **STEP_TOL)
        worst[name] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(card, cpu))
    for name, cfg in MF_REID:
        cpu, card = (mf_reid_run(name, cfg, d) for d in ('cpu', dev))
        if len(cpu) != len(card):
            raise AssertionError(f'{name}: {len(card)} != {len(cpu)}')
        for a, b in zip(card, cpu):
            torch.testing.assert_close(a, b, **STEP_TOL)
        worst[name] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(card, cpu))
    msf = narrow_flagship_cfg(aug=dict(FLAGSHIP_AUG, crop_size=32))
    msf['moco_mx_head'] = dict(type='MSCLWithAugMSFMxHead', basename='mx',
                               topk=5)
    card_vs_cpu(msf, [flagship_batch(4, hw=32, seed=s) for s in (17, 18)],
                'MSCLWithAug+MSCLWithAugMSFMxHead',
                required=list(MF_LOSSES) + ['loss_cls', 'loss_pos', 'loss'])
    rng = np.random.default_rng(19)
    card_vs_cpu(mf_two_r5_cfg(), [{'imgs': [
        rng.uniform(size=(4, 3, 8, 32, 32)).astype(np.float32)
        for _ in range(2)]} for _ in range(2)], 'MoCo+TwoR5')
    log(phase='mscl_family_card_vs_cpu', max_abs_diff=worst)
    return worst


def mf_tools(root, ft_pkls, ft_work):
    """(c) The two tools on the card's machine: clip_feature_extraction on
    finetune_cli's checkpoint (the fine-tune config at full width over its
    FT_VAL_VIDEOS test videos): finite (videos, FT_FEATURES) features and
    the videos' labels in the .npz; merge_pkls on two shards of an
    annotation list this phase writes (dealt out as flow_extraction
    --num-shards 2 does, one entry repeated across them): every video
    once, each entry the unsharded list's."""
    from mscl_torch.tools import clip_feature_extraction as cfe_cli
    from mscl_torch.tools import merge_pkls as merge_cli
    out = osp.join(root, 'mscl_family_features.npz')
    argv = [FT_CONFIG, osp.join(ft_work, 'epoch_2.pth'), '--out', out,
            '--cfg-options', *finetune_options(*ft_pkls, ft_work)]
    (feats, labels), launches, feat_s = cli_run(cfe_cli.main, argv)
    saved = np.load(out)
    want_labels = np.arange(FT_VAL_VIDEOS) % FT_CLASSES
    if sorted(saved.files) != ['features', 'labels'] or \
            saved['features'].shape != (FT_VAL_VIDEOS, FT_FEATURES) or \
            not np.isfinite(saved['features']).all() or \
            not np.array_equal(saved['labels'], want_labels) or \
            not np.array_equal(saved['features'], feats) or \
            any(launches.values()):
        raise AssertionError(f'features {saved["features"].shape}, labels '
                             f'{saved["labels"][:8]}, launches {launches}')
    annos = [dict(video_name=f'video_{v:03d}', total_frames=CLI_LIST,
                  flow_paths=[f'video_{v:03d}/flow_{i:05d}.np4'
                              for i in range(121)]) for v in range(CLI_VIDEOS)]
    shards = [annos[0::2], annos[1::2] + annos[:1]]
    for i, shard in enumerate(shards):
        with open(osp.join(root, f'annos_shard{i}.pkl'), 'wb') as f:
            pickle.dump(shard, f)
    merged_path = osp.join(root, 'annos_merged.pkl')
    merged, _, merge_s = cli_run(merge_cli.main, [
        osp.join(root, 'annos_shard*.pkl'), merged_path])
    with open(merged_path, 'rb') as f:
        on_disk = pickle.load(f)
    if on_disk != merged or sorted(
            merged, key=lambda a: a['video_name']) != annos:
        raise AssertionError(f'merged {len(merged)} annotations, not the '
                             f'{len(annos)} of the unsharded list')
    row = dict(features=list(saved['features'].shape), feature_s=feat_s,
               videos_per_s=FT_VAL_VIDEOS / feat_s, merged=len(merged),
               shards=[len(s) for s in shards], merge_s=merge_s)
    log(phase='mscl_family_tools', **row)
    return row


def phase_mscl_family(dev, root, pkls, ft_pkls, ft_work):
    """The rest of the MSCL family: (a) mf_flagship_cli, (b)
    mf_card_vs_cpu, (c) mf_tools."""
    t_phase = time.perf_counter()
    cli = mf_flagship_cli(root, pkls)
    worst = mf_card_vs_cpu(dev)
    tools = mf_tools(root, ft_pkls, ft_work)
    seconds = time.perf_counter() - t_phase
    log(phase='mscl_family', headline=dict(
        checks=f'{MF_LAUNCHES["l_neg"]} l_neg + {MF_LAUNCHES["dq"]} dq a '
               'step, finite losses, queues, card_vs_cpu 1e-3 '
               f'({len(worst)} heads and losses, 2 models), features, merge',
        seconds=round(seconds, 1), last_ms=round(cli['last_ms'], 1),
        step_ms=[round(v, 1) for v in cli['step_ms']],
        device_busy_ms=round(cli['device_busy_ms'], 1),
        idle_share=round(cli['device_idle_share'], 3),
        peak_GiB=round(cli['peak_bytes'] / 2 ** 30, 2),
        max_abs_diff=_short(max(worst.values())),
        features=tools['features'],
        feature_videos_per_s=round(tools['videos_per_s'], 2)))


LOC = 'configs/localization/'
LOC_CONFIGS = dict(
    bmn=LOC + 'bmn/bmn_400x100_2x8_9e_activitynet_feature.py',
    tem=LOC + 'bsn/bsn_tem_400x100_1x16_20e_activitynet_feature.py',
    pem=LOC + 'bsn/bsn_pem_400x100_1x16_20e_activitynet_feature.py',
    ssn=LOC + 'ssn/ssn_r50_450e_thumos14_rgb_train.py')
# the synthetic ActivityNet set: LOC_TRAIN videos for training (one batch
# of BMN's 8 or TEM's 16 each step, cycled), LOC_VAL for evaluation;
# LOC_T_RAW + v feature rows of 400 a video (resized to 100)
LOC_TRAIN, LOC_VAL, LOC_T_RAW, LOC_STEPS = 16, 4, 120, 3
LOC_PEM_STEPS = 3
# SSN: LOC_SSN_VIDEOS videos of LOC_SSN_FRAMES 128x171 JPEG frames, one a
# step (8 proposals x 9 segments = 72 frames at 224)
LOC_SSN_VIDEOS, LOC_SSN_FRAMES = 4, 96
# card against CPU: each model's outputs (eval mode) within this share of
# their spread (max - min) on the CPU (the recognition phases' logit
# share); BMN at batch 1, SSN over 2 proposals of the first video
LOC_SHARE = RC_LOGIT_TOL


def _loc_util():
    """tests/_torch_localization_util.py (numpy only): the synthetic
    ActivityNet, SSN and HVU sets the CPU tests write too."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        '_torch_localization_util', osp.join(
            osp.dirname(osp.abspath(__file__)), 'tests',
            '_torch_localization_util.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loc_model(name, dev, seed=0):
    cfg = Config.fromfile(LOC_CONFIGS[name])
    return build_model_from_cfg(cfg.model.to_dict(), device=dev, seed=seed), \
        cfg


def _loc_dataset(cfg, split, ann, prefix, **kw):
    from mscl_torch.datasets import build_dataset
    return build_dataset(dict(cfg.data[split].to_dict(), ann_file=ann,
                              data_prefix=prefix, **kw))


def _loc_share(card, cpu):
    """The card's largest gap from the CPU over the CPU's spread, the
    largest over a tuple of outputs."""
    worst = 0.0
    for a, b in zip(card, cpu):
        a, b = a.detach().cpu().double(), b.detach().double()
        worst = max(worst, ((a - b).abs().max() / (b.max() - b.min()))
                    .item())
    return worst


def _loc_optimizer(model, cfg, steps_per_epoch):
    """The config's optimizer under its lr policy."""
    lr = build_lr_schedule(dict(cfg.get('lr_config') or {}),
                           cfg.optimizer['lr'], cfg.total_epochs,
                           steps_per_epoch)
    return build_optimizer(model, dict(cfg.optimizer), lr, grad_clip=(
        cfg.get('optimizer_config') or {}).get('grad_clip'))


def _loc_train(model, opt, batches, dev):
    """LOC_STEPS steps (host batches, cycled), each to a synchronise: the
    losses and each step's ms; then one more step profiled and the peak
    memory."""
    step = make_train_step(model, opt)
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(LOC_STEPS):
        batch = to_torch(batches[i % len(batches)], dev)
        t0 = time.perf_counter()
        log_vars = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in log_vars.items()})
    prof = profile(f'localization_{type(model).__name__}',
                   lambda: step(to_torch(batches[0], dev)))
    for lv in losses:
        if not all(math.isfinite(v) for v in lv.values()):
            raise AssertionError(f'{type(model).__name__} logged {lv}')
    return dict(losses=[lv['loss'] for lv in losses], step_ms=ms,
                steady_ms=sum(ms[1:]) / len(ms[1:]),
                device_ms=prof['device_busy_ms'],
                idle_share=prof['device_idle_share'],
                peak_bytes=torch.cuda.max_memory_allocated())


def _activitynet_eval(dataset, proposals, prefix):
    """The dataset's AR@AN and AUC for ``proposals`` (a proposal list a
    video, in its order), each in [0, 1] (AUC in [0, 100])."""
    results = [dict(video_name=info['video_name'], proposal_list=p)
               for info, p in zip(dataset.video_infos, proposals)]
    metrics = dataset.evaluate(results)
    for k, v in metrics.items():
        if not (math.isfinite(v) and 0 <= v <= (100 if k == 'auc' else 1)):
            raise AssertionError(f'{prefix} {k} = {v}')
    if not all(proposals):
        raise AssertionError(f'{prefix}: a video without proposals')
    return metrics


def _bmn_path(dev, ann, val_ann, feats):
    """BMN at full width: the sample mask's host build, the
    boundary-matching product timed against torch.matmul's bound, steps
    under the config's Adam, then the val videos' proposals and AR@AN."""
    from mscl_torch.models.localizers import bmn as bmn_mod
    bmn_mod.build_interp1d_mask.cache_clear()
    t0 = time.perf_counter()
    mask = bmn_mod.build_interp1d_mask(100, 32, 3, 0.5)
    mask_s = time.perf_counter() - t0
    model, cfg = _loc_model('bmn', dev)
    model.seed_dropout(0)
    ds = _loc_dataset(cfg, 'train', ann, feats)
    bs = cfg.data['videos_per_gpu']
    batches = []
    for b in range(LOC_TRAIN // bs):
        items = [ds[i] for i in range(b * bs, (b + 1) * bs)]
        conf, start, end = model.generate_labels(
            [it['gt_bbox'] for it in items])
        batches.append(dict(raw_feature=np.stack(
            [it['raw_feature'] for it in items]), label_confidence=conf,
            label_start=start, label_end=end))
    opt = _loc_optimizer(model, cfg, len(batches))
    run = _loc_train(model, opt, batches, dev)
    # the boundary-matching product at the step's shape
    conf = torch.randn(bs, 256, 100, device=dev)
    smask = model._sample_mask(dev)
    bm_ms = time_ms(lambda: torch.matmul(conf, smask), iters=10)
    bm_bound = bound(4 * (conf.numel() + smask.numel() +
                          bs * 256 * smask.shape[1]),
                     2.0 * bs * 256 * 100 * smask.shape[1])
    val = _loc_dataset(cfg, 'val', val_ann, feats)
    model.eval()
    x = torch.from_numpy(np.stack([val[i]['raw_feature']
                                   for i in range(len(val))])).to(dev)
    with torch.no_grad():
        cm, s, e = model.forward_test(x)
    t0 = time.perf_counter()
    props = [model.proposals_from_outputs(cm[i], s[i], e[i], info)
             for i, info in enumerate(val.video_infos)]
    post_s = time.perf_counter() - t0
    metrics = _activitynet_eval(val, props, 'BMN')
    return dict(run, mask_build_s=mask_s, mask_mb=mask.nbytes / 2 ** 20,
                mask_nonzero_share=float((mask != 0).mean()),
                bm_matmul_ms=bm_ms, bm_bound_ms=bm_bound[0],
                bm_bound_by=bm_bound[1], post_s=post_s, metrics=metrics)


def _bsn_path(dev, root, ann, full_ann, val_ann, feats):
    """TEM at full width under its SGD; its results for every video as
    the TEM csv files; the ported proposal generation; PEM on what it
    writes (each step one batch's proposals, ragged over the videos, as
    one row set: PEM scores each proposal alone), then the val videos'
    proposals and AR@AN."""
    from mscl_torch.tools import bsn_proposal_generation as pgm_tool
    tem, cfg = _loc_model('tem', dev)
    ds = _loc_dataset(cfg, 'train', ann, feats)
    bs = cfg.data['videos_per_gpu']
    items = [ds[i] for i in range(len(ds))]
    action, start, end = tem.generate_labels([it['gt_bbox'] for it in items])
    batches = [dict(raw_feature=np.stack([it['raw_feature'] for it in
                                          items[:bs]]),
                    label_action=action[:bs], label_start=start[:bs],
                    label_end=end[:bs])]
    tem_run = _loc_train(tem, _loc_optimizer(tem, cfg, 1), batches, dev)
    full = _loc_dataset(cfg, 'test', full_ann, feats)
    tem_dir = osp.join(root, 'tem_results')
    os.makedirs(tem_dir)
    tem.eval()
    with torch.no_grad():
        out = tem.forward_test(torch.from_numpy(np.stack(
            [full[i]['raw_feature'] for i in range(len(full))])).to(dev))
    tmins = np.arange(100) / 100
    for info, curves in zip(full.video_infos, out.cpu().numpy()):
        np.savetxt(osp.join(tem_dir, info['video_name'] + '.csv'),
                   np.concatenate([curves, np.stack(
                       [tmins, tmins + 0.01], 1)], 1), delimiter=',',
                   header='action,start,end,tmin,tmax', comments='')
    pgm = osp.join(root, 'pgm')
    t0 = time.perf_counter()
    done = pgm_tool.main([full_ann, '--tem-results-dir', tem_dir,
                          '--pgm-proposals-dir', pgm + '_proposals',
                          '--pgm-features-dir', pgm + '_features',
                          '--temporal-scale', '100', '--top-k', '1000',
                          '--num-workers', '4'])
    pgm_s = time.perf_counter() - t0
    if done != len(full):
        raise AssertionError(f'PGM made {done} videos of {len(full)}')
    pem, pcfg = _loc_model('pem', dev)
    pem.seed_dropout(0)
    dirs = dict(pgm_proposals_dir=pgm + '_proposals/',
                pgm_features_dir=pgm + '_features/')

    def pipeline(split):
        return [dict(t, **dirs) if t['type'] == 'LoadProposals' else t
                for t in pcfg.data[split]['pipeline']]
    from mscl_torch.datasets import build_dataset
    pds = build_dataset(dict(pcfg.data['train'].to_dict(), ann_file=ann,
                             data_prefix=feats, pipeline=pipeline('train')))
    pbs = pcfg.data['videos_per_gpu']
    rows = [pds[i] for i in range(min(pbs, len(pds)))]
    batches = [dict(bsp_feature=np.concatenate(
        [r['bsp_feature'] for r in rows])[None],
        reference_temporal_iou=np.concatenate(
        [r['reference_temporal_iou'] for r in rows])[None])]
    pem_run = _loc_train(pem, _loc_optimizer(pem, pcfg, 1), batches, dev)
    test = build_dataset(dict(pcfg.data['test'].to_dict(), ann_file=val_ann,
                              data_prefix=feats, pipeline=pipeline('test')))
    pem.eval()
    props = []
    for i in range(len(test)):
        r = test[i]
        with torch.no_grad():
            scores = pem.forward_test(torch.as_tensor(
                r['bsp_feature']).to(dev))
        meta = test.video_infos[i]
        props.append(pem.proposals_from_outputs(
            scores, r['tmin'], r['tmax'], r['tmin_score'], r['tmax_score'],
            meta))
    metrics = _activitynet_eval(test, props, 'BSN')
    return dict(tem=tem_run, pem=pem_run, pgm_s=pgm_s,
                pem_rows=int(batches[0]['bsp_feature'].shape[1]),
                metrics=metrics)


def _ssn_path(root):
    """SSN's shipped config through train_model (ResNet-50, 224 crops, 8
    proposals x 9 segments a video, a video a step, SGD with clip 40), a
    test pass over every proposal of each video (mode 'val' sampling, the
    same STPP), evaluate's mAP, then the ported report_map on an
    ActivityNet-format copy of the detections."""
    from mscl_torch.apis import train_model
    from mscl_torch.datasets.pipelines import Compose
    from mscl_torch.tools import report_map as report_tool
    lu = _loc_util()
    sroot = osp.join(root, 'ssn')
    os.makedirs(sroot)
    ann = lu.write_ssn_set(sroot, jpeg.imwrite, n_videos=LOC_SSN_VIDEOS,
                           n_frames=LOC_SSN_FRAMES, hw=(128, 171),
                           num_classes=20)
    work = osp.join(root, 'ssn_work')
    cfg = Config.fromfile(LOC_CONFIGS['ssn'])
    cfg.merge_from_dict({'data.train.ann_file': ann,
                         'data.train.data_prefix': sroot,
                         'total_epochs': 1, 'work_dir': work,
                         'log_config.interval': 1,
                         'checkpoint_config.interval': 1})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner, model = train_model(cfg, validate=False, seed=0)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = [r for r in read_log(work) if r['mode'] == 'train']
    if len(lines) != LOC_SSN_VIDEOS or not all(
            math.isfinite(r[k]) for r in lines for k in r
            if k.startswith('loss')):
        raise AssertionError(f'SSN logged {lines}')
    # one more step of a train batch, profiled: the step's device time and
    # idle share without the data wait
    it = iter(runner.train_loader)
    try:
        batch = to_torch(next(it), 'cuda')
    finally:
        it.close()
    step = make_train_step(model, runner.optimizer)
    prof = profile('localization_SSN', lambda: step(batch))
    ds = runner.train_loader.dataset
    test_pipe = Compose([
        dict(type='SampleProposalFrames', clip_len=1, body_segments=5,
             aug_segments=(2, 2), aug_ratio=0.5, mode='val'),
        dict(type='RawFrameDecode'),
        dict(type='Resize', scale=(224, 224), keep_ratio=False),
        dict(type='Normalize', mean=[104, 117, 128], std=[1, 1, 1],
             to_bgr=True),
        dict(type='FormatShape', input_format='NPTCHW')])
    model.eval()
    results, inputs = [], None
    t0 = time.perf_counter()
    for info in ds.video_infos:
        props = info['proposals']
        item = test_pipe(dict(info, filename_tmpl=ds.filename_tmpl,
                              modality='RGB', start_index=ds.start_index,
                              out_proposals=[((info['video_id'], p), 0)
                                             for p in props]))
        imgs = torch.from_numpy(item['imgs'][None]).cuda()
        scale = torch.tensor([[ds._get_stage(p, info['total_frames'])
                               for p in props]], dtype=torch.float32).cuda()
        inputs = inputs or (imgs[:, :2].cpu(), scale[:, :2].cpu())
        with torch.no_grad():
            act, comp, reg = model.forward_test(imgs, scale)
        results.append(dict(
            relative_proposal_list=np.array(
                [(p.start_frame / info['total_frames'],
                  p.end_frame / info['total_frames']) for p in props],
                np.float32),
            activity_scores=act.cpu().numpy(),
            completeness_scores=comp.cpu().numpy(),
            bbox_preds=reg.cpu().numpy()))
    test_s = time.perf_counter() - t0
    metrics = ds.evaluate(results)
    if not all(math.isfinite(v) and 0 <= v <= 1 for v in metrics.values()):
        raise AssertionError(f'SSN mAP {metrics}')
    # report_map: SSN's detections as class-agnostic ActivityNet proposals
    # (in frames as seconds), the activity argmax a video as its label
    dets = ds.results_to_detections(results, top_k=200)
    gt, proposal, cls_pred = {}, {}, {}
    for idx, info in enumerate(ds.video_infos):
        vid, n = info['video_id'], info['total_frames']
        gt['v_' + vid] = dict(annotations=[dict(
            segment=[g.start_frame, g.end_frame], label=f'c{g.label}')
            for g in info['gts']])
        proposal[vid] = [dict(segment=[float(r[0] * n), float(r[1] * n)],
                              score=float(r[2]))
                         for c in dets for r in c.get(vid, [])]
        act = results[idx]['activity_scores'][:, 1:].mean(0)
        cls_pred[vid] = [dict(label=f'c{c + 1}', score=float(s))
                         for c, s in enumerate(act)]
    paths = {k: osp.join(root, f'ssn_{k}.json') for k in ('gt', 'prop', 'cls')}
    for k, obj in (('gt', gt), ('prop', dict(results=proposal)),
                   ('cls', dict(results=cls_pred))):
        with open(paths[k], 'w') as f:
            json.dump(obj, f)
    report = report_tool.main(['--proposal', paths['prop'], '--gt',
                               paths['gt'], '--cls-pred', paths['cls'],
                               '--det-output', osp.join(root, 'ssn_det.json')])
    if not 0 <= report['average_mAP'] <= 1:
        raise AssertionError(f'report_map {report}')
    ms = [r['time'] * 1e3 for r in lines]
    return dict(losses=[r['loss'] for r in lines], step_ms=ms,
                steady_ms=sum(ms[1:]) / len(ms[1:]),
                data_ms=[r['data_time'] * 1e3 for r in lines],
                device_ms=prof['device_busy_ms'],
                idle_share=prof['device_idle_share'],
                peak_bytes=peak, train_s=train_s, test_s=test_s,
                metrics=metrics, report_average_map=report['average_mAP'],
                model=model, inputs=inputs)


def _loc_card_vs_cpu(dev, feats, ssn):
    """BMN (batch 1), TEM, PEM and SSN forward (eval mode) at full width
    on the card and on the CPU from the same weights and input, each
    within LOC_SHARE of the CPU's spread; BMN's losses on both devices
    with the same uniforms (the CPU's draws handed to both) within
    RC_LOSS_TOL."""
    from mscl_torch.models.losses import bmn_loss
    rng = np.random.default_rng(7)
    shares, held = {}, {}
    cases = dict(bmn=rng.normal(size=(1, 100, 400)),
                 tem=rng.normal(size=(2, 100, 400)),
                 pem=rng.uniform(size=(1, 500, 32)))
    for name, x in cases.items():
        outs = {}
        for d in ('cpu', 'cuda'):
            model = _loc_model(name, d, seed=1)[0].eval()
            with torch.no_grad():
                out = model(torch.from_numpy(x.astype(np.float32)).to(d))
            outs[d] = out if isinstance(out, tuple) else (out,)
            held[name] = model
        shares[name] = _loc_share(outs['cuda'], outs['cpu'])
        if name == 'bmn':
            bmn_outs = outs
    # BMN's losses on each device's outputs, the same uniforms on both
    conf, start, end = held['bmn'].generate_labels(
        [np.array([[0.1, 0.4], [0.5, 0.9]])])
    draws = bmn_loss.draw_uniforms(torch.Generator().manual_seed(3),
                                   conf.shape, 'cpu')
    real, losses = bmn_loss.draw_uniforms, {}
    bmn_loss.draw_uniforms = lambda g, shape, d: tuple(u.to(d)
                                                       for u in draws)
    try:
        for d in ('cpu', 'cuda'):
            labels = [torch.from_numpy(a).to(d) for a in (conf, start, end)]
            losses[d] = [v.item() for v in bmn_loss.BMNLoss()(
                *bmn_outs[d], *labels, held['bmn'].bm_mask.to(d))]
    finally:
        bmn_loss.draw_uniforms = real
    loss_diff = max(abs(a - b) for a, b in zip(losses['cuda'],
                                                losses['cpu']))
    # SSN: the trained model's weights on both devices, two proposals
    model, (imgs, scale) = ssn['model'], ssn['inputs']
    cpu = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        card_out = model.forward_test(imgs.to(dev), scale.to(dev))
        cpu_out = cpu.forward_test(imgs, scale)
    shares['ssn'] = _loc_share(card_out, cpu_out)
    bad = {k: v for k, v in shares.items() if not v <= LOC_SHARE}
    if bad or not loss_diff <= RC_LOSS_TOL:
        raise AssertionError(f'localization card vs CPU: shares {shares}, '
                             f'BMN loss gap {loss_diff}')
    return dict(shares=shares, bmn_loss_diff=loss_diff,
                bmn_losses=dict(zip(('total', 'tem', 'pem_reg', 'pem_cls'),
                                    losses['cuda'])))


def _hvu_refusals(root):
    """tsn_r18_1x1x8_100e_hvu_action_rgb through the training CLI on a
    synthetic HVU set stops by name before its first step where JAX's
    fails: at the None filename_tmpl the config leaves (ValueError), and
    with one set, at LoadHVULabel meeting the one-hot target HVUDataset
    made (TypeError); its model, on the card, refuses the one-hot target
    (Recognizer2D's multi_class refusal)."""
    lu = _loc_util()
    hroot = osp.join(root, 'hvu')
    os.makedirs(hroot)
    ann = lu.write_hvu(hroot, jpeg.imwrite, category_nums=(('action', 739),))
    cfg_path = 'configs/recognition/tsn/tsn_r18_1x1x8_100e_hvu_action_rgb.py'
    out = {}
    for extra, err, word in (
            ((), ValueError, 'filename_tmpl'),
            (('data.train.filename_tmpl=img_{:05d}.jpg',), TypeError,
             'LoadHVULabel')):
        work = osp.join(hroot, f'work_{word}')
        try:
            cli_run(train_cli.main, [
                cfg_path, '--seed', '0', '--cfg-options',
                f'data.train.ann_file={ann}',
                f'data.train.data_prefix={hroot}',
                'data.videos_per_gpu=2', 'total_epochs=1',
                f'work_dir={work}', *extra])
        except err as e:
            if word not in str(e):
                raise
            out[word] = str(e)[:60]
        else:
            raise AssertionError(f'the HVU config trained ({word})')
        logged = osp.join(work, 'log.json')
        if osp.exists(logged) and open(logged).read().strip():
            raise AssertionError(f'the HVU config logged a step ({word})')
    model = build_model_from_cfg(Config.fromfile(cfg_path).model.to_dict(),
                                 device='cuda')
    label = torch.zeros(2, 739, device='cuda')
    label[:, 3] = 1
    try:
        model.train_step(dict(imgs=torch.zeros(2, 8, 3, 64, 64,
                                               device='cuda'), label=label))
    except NotImplementedError as e:
        if 'multi_class' not in str(e):
            raise
        out['multi_class'] = str(e)[:60]
    else:
        raise AssertionError('the HVU model took a one-hot target')
    return out


def phase_localization(root):
    """BMN, BSN (TEM -> proposal generation -> PEM) and SSN at the shipped
    configs' full widths on synthetic data from a seed: each trains a few
    steps and is evaluated (AR@AN and AUC; SSN's mAP and report_map);
    card against CPU for the four models' outputs and BMN's losses. No
    kernel of the port launches."""
    dev = torch.device('cuda')
    t_phase = time.perf_counter()
    lu = _loc_util()
    root = osp.join(root, 'localization')
    os.makedirs(root)
    n = LOC_TRAIN + LOC_VAL
    full_ann, feats = lu.write_activitynet(root, n, LOC_T_RAW, 400, seed=3)
    with open(full_ann) as f:
        anno = json.load(f)
    names = sorted(anno)
    anns = {}
    for split, keep in (('train', names[:LOC_TRAIN]),
                        ('val', names[LOC_TRAIN:])):
        anns[split] = osp.join(root, f'anno_{split}.json')
        with open(anns[split], 'w') as f:
            json.dump({k: anno[k] for k in keep}, f)
    reset_launch_counts()
    t0 = time.perf_counter()
    bmn = _bmn_path(dev, anns['train'], anns['val'], feats)
    bmn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsn = _bsn_path(dev, root, anns['train'], full_ann, anns['val'], feats)
    bsn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssn = _ssn_path(root)
    ssn_s = time.perf_counter() - t0
    launched = dict(l_neg=di.l_neg.launches, dq=di.dq.launches,
                    corr_lookup=cl.corr_lookup.launches)
    if any(launched.values()):
        raise AssertionError(f'localization launched {launched}')
    t0 = time.perf_counter()
    hvu = _hvu_refusals(root)
    hvu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cvc = _loc_card_vs_cpu(dev, feats, ssn)
    cvc_s = time.perf_counter() - t0
    ssn.pop('model'), ssn.pop('inputs')
    seconds = time.perf_counter() - t_phase
    log(phase='localization', bmn=bmn, bsn=bsn, ssn=ssn, card_vs_cpu=cvc,
        hvu_refusals=hvu, bmn_s=bmn_s, bsn_s=bsn_s, ssn_s=ssn_s,
        hvu_s=hvu_s, card_vs_cpu_s=cvc_s,
        seconds=seconds, launches=launched)

    def row(r):
        return [round(r['steady_ms'], 1), round(r.get('idle_share') or 0, 3),
                round(r['peak_bytes'] / 2 ** 30, 2)]
    log(phase='localization', headline=dict(
        checks='BMN, TEM -> PGM -> PEM and SSN trained at full width and '
               'evaluated (AR@AN, AUC, mAP, report_map); card vs CPU '
               'within its share; the HVU config refused by name (3); '
               '0 kernel launches',
        bmn=row(bmn), tem=row(bsn['tem']), pem=row(bsn['pem']),
        ssn=row(ssn), ssn_device_ms=round(ssn['device_ms'], 1),
        keys='steady_ms, idle_share (a step profiled), peak_GiB',
        mask_build_s=round(bmn['mask_build_s'], 2),
        bm_matmul_ms=[round(bmn['bm_matmul_ms'], 3),
                      round(bmn['bm_bound_ms'], 3)],
        auc=[round(bmn['metrics']['auc'], 2),
             round(bsn['metrics']['auc'], 2)],
        ssn_map50=round(ssn['metrics']['mAP@0.50'], 3),
        worst_share=_short(max(cvc['shares'].values())),
        parts_s=dict(bmn=round(bmn_s, 1), bsn=round(bsn_s, 1),
                     ssn=round(ssn_s, 1), hvu=round(hvu_s, 1),
                     cvc=round(cvc_s, 1))))


AUDIO = 'configs/recognition_audio/resnet/'
AUDIO_CONFIGS = dict(
    feature=AUDIO + 'tsn_r50_64x1x1_100e_kinetics400_audio_feature.py',
    raw=AUDIO + 'tsn_r50_64x1x1_100e_kinetics400_audio.py')
# AUDIO_WAVS wavs of AUDIO_SECONDS s at 16 kHz (int16), each listed twice
# in the train lists: AUDIO_STEPS steps at the configs' batch of 32; the
# first AUDIO_VAL for validation and the test CLI (10 clips a video)
AUDIO_WAVS, AUDIO_SECONDS, AUDIO_VAL, AUDIO_STEPS = 64, 10, 16, 4
# card against CPU: each model's logits (eval mode) on AUDIO_CVC_CLIPS
# clips within this share of their spread
AUDIO_CVC_CLIPS = 8
DET = 'configs/detection/'
DET_MAIN = DET + 'ava/slowonly_r50_4x16x1_20e_ava_rgb.py'
# the distinct models: card against CPU on one clip of DET_ROIS RoIs,
# forward (eval) and one step (train mode, dropout 0)
DET_CHECKED = (
    ('slowonly_r50', 'ava/slowonly_r50_4x16x1_20e_ava_rgb.py'),
    ('slowonly_r101', 'ava/slowonly_r101_8x8x1_20e_ava_rgb.py'),
    ('slowonly_nl', 'ava/slowonly_nl_r50_4x16x1_10e_ava_rgb.py'),
    ('slowfast_4x16', 'ava/slowfast_r50_4x16x1_20e_ava_rgb.py'),
    ('slowfast_context', 'ava/slowfast_context_r50_4x16x1_20e_ava_rgb.py'),
    ('slowfast_max_focal', 'ava/slowfast_temporal_max_focal_alpha3_gamma1_'
     'r50_8x8x1_cosine_10e_ava22_rgb.py'),
    ('lfb_nl', 'lfb/lfb_nl_r50_4x16x1_20e_ava_rgb.py'),
    ('acrn', 'acrn/slowfast_acrn_r50_8x8x1_cosine_10e_ava22_rgb.py'))
# the others: built and one forward on the card
DET_FORWARD = (
    'ava/slowonly_r50_4x16x1_20e_ava_rgb_custom_classes.py',
    'ava/slowfast_r50_4x16x1_20e_ava_rgb_custom_classes.py',
    'ava/slowfast_r50_8x8x1_20e_ava_rgb.py',
    'ava/slowfast_r50_8x8x1_cosine_10e_ava22_rgb.py',
    'ava/slowfast_temporal_max_r50_8x8x1_cosine_10e_ava22_rgb.py',
    'ava/slowonly_nl_r50_8x8x1_10e_ava_rgb.py',
    'lfb/lfb_avg_r50_4x16x1_20e_ava_rgb.py',
    'lfb/lfb_max_r50_4x16x1_20e_ava_rgb.py')
# the AVA-shaped set: DET_VIDEOS videos of 320x240 JPEG frames (16 distinct,
# encoded once) around DET_KEYFRAMES; one keyframe excluded, so the train
# run takes DET_STEPS steps of the config's 8
DET_VIDEOS, DET_KEYFRAMES, DET_STEPS, DET_ROIS = 8, (902, 903, 904, 905,
                                                     906), 4, 8
DET_LFB = 'lfb/lfb_nl_r50_4x16x1_20e_ava_rgb.py'


def _util(name):
    """A numpy-only helper module of tests/ by its file name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, osp.join(
        osp.dirname(osp.abspath(__file__)), 'tests', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _audio_lists(root):
    """The train lists (each wav or feature twice) and the val list (the
    first AUDIO_VAL), "name total_frames label" at 30 frames a second."""
    paths = {}
    frames = AUDIO_SECONDS * 30
    for name, suffix in (('feature', ''), ('raw', '.wav')):
        rows = [f'clip_{i}{suffix} {frames} {i % 400}\n'
                for i in range(AUDIO_WAVS)]
        for split, lines in (('train', rows * 2), ('val', rows[:AUDIO_VAL])):
            paths[name, split] = osp.join(root, f'{name}_{split}.txt')
            with open(paths[name, split], 'w') as f:
                f.writelines(lines)
    return paths


def _cli_row(runner, work, key, name):
    """A training CLI run's log: the losses finite, the steady window's
    (steps 3-) ms and data wait, then one more step profiled."""
    train = [r for r in read_log(work) if r['mode'] == 'train']
    if len(train) < AUDIO_STEPS or not all(
            math.isfinite(r[k]) for r in train for k in r
            if k.startswith('loss')):
        raise AssertionError(f'{name}: {train}')
    steady = train[2:]
    step_s = sum(r['time'] for r in steady) / len(steady)
    it = iter(runner.train_loader)
    batch = to_torch(next(it), 'cuda')
    it.close()
    prof = profile(f'{name}_step', lambda: runner._train_step(batch))
    return dict(batch=list(batch[key].shape), steps=len(train),
                steady_ms=step_s * 1e3,
                data_wait_ms=sum(r['data_time'] for r in steady) /
                len(steady) * 1e3,
                device_ms=prof['device_busy_ms'],
                idle_share=prof['device_idle_share'],
                losses=[r['loss'] for r in train])


def _share(card, cpu):
    card, cpu = card.detach().cpu().double(), cpu.detach().double()
    return ((card - cpu).abs().max() / (cpu.max() - cpu.min())).item()


def _audio_card_vs_cpu(model_cfg, batch):
    """The model on the card and on the CPU from seed 1: forward_test's
    logits (eval mode, before the softmax) within RC_LOGIT_TOL of their
    spread."""
    logits = {}
    for dev in ('cuda', 'cpu'):
        model = build_model_from_cfg(dict(model_cfg), device=dev, seed=1)
        model.test_cfg['average_clips'] = None
        model.eval()
        with torch.no_grad():
            logits[dev] = model.forward_test(torch.from_numpy(
                batch).to(dev)).cpu()
    share = _share(logits['cuda'], logits['cpu'])
    if not share <= RC_LOGIT_TOL:
        raise AssertionError(f'{model_cfg["backbone"]["type"]}: card vs '
                             f'CPU {share}')
    return share


def phase_audio(root):
    """The audio recipes at the configs' full widths: AUDIO_WAVS wavs of
    AUDIO_SECONDS s written (int16, 16 kHz) and turned into log-mel
    features by the ported build_audio_features (4 workers); the feature
    config (ResNetAudio-50, base 32, 128x80 clips) through the training CLI
    for AUDIO_STEPS steps at batch 32 with validation, then the test CLI
    on its checkpoint (10 clips a video) and evaluate; the raw-audio config
    (a 2D ResNet-50 over 1-channel log-mels of 2 s crops) for AUDIO_STEPS
    steps; card against CPU for both models. No kernel of the port
    launches."""
    from mscl_torch.datasets import build_dataset
    from mscl_torch.datasets.loader import default_collate
    from mscl_torch.tools import build_audio_features
    t_phase = time.perf_counter()
    root = osp.join(root, 'audio')
    wav_dir, feat_dir = osp.join(root, 'wavs'), osp.join(root, 'features')
    os.makedirs(wav_dir)
    t0 = time.perf_counter()
    _util('_torch_ava_util').write_wavs(wav_dir, n=AUDIO_WAVS,
                                        seconds=AUDIO_SECONDS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = build_audio_features.main([wav_dir, feat_dir,
                                       '--num-workers', '4'])
    features_s = time.perf_counter() - t0
    if built != AUDIO_WAVS or np.load(osp.join(
            feat_dir, 'clip_0.npy')).shape != (640, 80):
        raise AssertionError(f'build_audio_features: {built} wavs')
    lists = _audio_lists(root)
    rows, cvc, launched = {}, {}, {}
    for name, prefix in (('feature', feat_dir), ('raw', wav_dir)):
        work = osp.join(root, f'{name}_work')
        opts = [f'data.train.ann_file={lists[name, "train"]}',
                f'data.train.data_prefix={prefix}', 'total_epochs=1',
                'checkpoint_config.interval=1', 'log_config.interval=1',
                f'work_dir={work}']
        if name == 'feature':
            opts += [f'data.{s}.{k}={v}' for s in ('val', 'test')
                     for k, v in (('ann_file', lists[name, 'val']),
                                  ('data_prefix', prefix))]
            opts.append('evaluation.interval=1')
        torch.cuda.reset_peak_memory_stats()
        (runner, model), launches, run_s = cli_run(
            train_cli.main, [AUDIO_CONFIGS[name], '--seed', '0'] +
            (['--validate'] if name == 'feature' else []) +
            ['--cfg-options', *opts])
        launches['corr_lookup'] = cl.corr_lookup.launches
        launched[name] = launches
        rows[name] = dict(_cli_row(runner, work, 'audios', f'audio_{name}'),
                          run_s=run_s,
                          peak_bytes=torch.cuda.max_memory_allocated())
        cfg = Config.fromfile(AUDIO_CONFIGS[name])
        ds = build_dataset(dict(cfg.data.train.to_dict(),
                                ann_file=lists[name, 'train'],
                                data_prefix=prefix))
        np.random.seed(0)
        batch = default_collate([ds[i] for i in range(AUDIO_CVC_CLIPS)])
        cvc[name] = _audio_card_vs_cpu(cfg.model.to_dict(), batch['audios'])
        if name == 'feature':
            val = [r for r in read_log(work) if r['mode'] == 'val']
            if len(val) != 1 or not 0 <= val[0]['top1_acc'] <= 1:
                raise AssertionError(f'audio validation: {val}')
            t0 = time.perf_counter()
            metrics, test_launches, _ = cli_run(test_cli.main, [
                AUDIO_CONFIGS[name], osp.join(work, 'epoch_1.pth'),
                '--cfg-options', f'data.test.ann_file={lists[name, "val"]}',
                f'data.test.data_prefix={prefix}', f'work_dir={work}'])
            test_s = time.perf_counter() - t0
            if not all(0 <= v <= 1 for v in metrics.values()) or \
                    'top1_acc' not in metrics:
                raise AssertionError(f'audio test CLI: {metrics}')
            launched['test'] = test_launches
        del runner, model
        torch.cuda.empty_cache()
    if any(v for d in launched.values() for v in d.values()):
        raise AssertionError(f'audio launched {launched}')
    seconds = time.perf_counter() - t_phase
    log(phase='audio', rows=rows, card_vs_cpu=cvc, test_metrics=metrics,
        write_s=write_s, features_s=features_s, test_s=test_s,
        seconds=seconds, launches=launched)
    log(phase='audio', headline=dict(
        checks=f'{AUDIO_WAVS} wavs -> build_audio_features; the feature '
               f'and raw configs trained ({AUDIO_STEPS} steps at 32, '
               f'validation), the test CLI (10 clips) evaluated; card vs '
               f'CPU within its share; 0 kernel launches',
        **{name: [round(r['steady_ms'], 1), round(r['data_wait_ms'], 1),
                  round(r['device_ms'], 1),
                  round(r['idle_share'] or 0, 3),
                  round(r['peak_bytes'] / 2 ** 30, 2)]
           for name, r in rows.items()},
        keys='steady_ms, data_wait_ms, device_ms and idle_share (a step '
             'profiled), peak_GiB',
        test_top1=round(metrics['top1_acc'], 3),
        worst_share=_short(max(cvc.values())),
        parts_s=dict(write=round(write_s, 1), features=round(features_s, 1),
                     feature=round(rows['feature']['run_s'], 1),
                     raw=round(rows['raw']['run_s'], 1),
                     test=round(test_s, 1))))


def _jpeg_writer():
    """``imwrite(path, img)`` through the port's JPEG encoder, each distinct
    array encoded once."""
    cache = {}

    def imwrite(path, img):
        if id(img) not in cache:
            cache[id(img)] = (img, jpeg.encode_jpeg(img, 90))
        with open(path, 'wb') as f:
            f.write(cache[id(img)][1])
    return imwrite


def _det_options(ava, work):
    return [f'data.train.ann_file={ava["ann"]}',
            f'data.train.exclude_file={ava["exclude"]}',
            f'data.train.proposal_file={ava["proposals"]}',
            f'data.train.data_prefix={ava["prefix"]}', 'total_epochs=1',
            'checkpoint_config.interval=1', 'log_config.interval=1',
            f'work_dir={work}']


def _det_clip(cfg, ava):
    """One clip of the config's own train pipeline over the set (seed 0):
    imgs (1, 3, T, 256, 256) and its first DET_ROIS RoIs as the flat
    (R, 5) form, with their labels and weights."""
    from mscl_torch.datasets import build_dataset
    ds_cfg = dict(cfg.data.train.to_dict(), ann_file=ava['ann'],
                  exclude_file=ava['exclude'],
                  proposal_file=ava['proposals'], data_prefix=ava['prefix'])
    random.seed(0)
    np.random.seed(0)
    item = build_dataset(ds_cfg)[0]
    rois = np.concatenate([np.zeros((DET_ROIS, 1), np.float32),
                           item['rois'][:DET_ROIS]], 1)
    return dict(imgs=item['imgs'][None], rois=rois,
                labels=item['roi_labels'][:DET_ROIS],
                valid_mask=(item['roi_weights'][:DET_ROIS] > 0).astype(
                    np.float32))


def _det_model(path, dev):
    """A config's detector from seed 1, every dropout site at 0 (the
    card's masks are not the CPU's)."""
    from mscl_torch.models.heads.base import RateDropout
    cfg = Config.fromfile(DET + path)
    model = build_model_from_cfg(cfg.model.to_dict(), device=dev, seed=1)
    for m in model.modules():
        if isinstance(m, RateDropout):
            m.dropout_ratio = 0.0
    return model, cfg


def _det_pass(path, clip, dev):
    """forward_test's scores (eval mode), then in train mode the step's
    loss and the bbox head's gradient."""
    model, _ = _det_model(path, dev)
    on = {k: torch.from_numpy(v).to(dev) for k, v in clip.items()}
    model.eval()
    with torch.no_grad():
        scores = model.forward_test(on['imgs'], on['rois']).cpu()
    model.train()
    loss, _ = model.train_step(on)
    fc = model.bbox_head.fc_cls
    grads = torch.autograd.grad(loss, [fc.weight, fc.bias])
    return dict(scores=scores, loss=loss.item(),
                grads=[g.cpu() for g in grads], model=model, on=on)


def _det_cpu_reference(task):
    """The CPU's side of a detector's check, in a reference_pool worker:
    its scores, loss and head gradient from the same seed and clip."""
    t0 = time.perf_counter()
    out = _det_pass(task['path'], task['clip'], 'cpu')
    out.pop('model'), out.pop('on')
    out['seconds'] = time.perf_counter() - t0
    return out


def _det_card_vs_cpu(pool, path, clip):
    """A detector on the card and on the CPU (in ``pool``) from seed 1 on
    one clip: the scores within RC_LOGIT_TOL of their spread, the step's
    loss within RC_LOSS_TOL, the head's gradient within RC_GRAD_TOL
    (relative norm); on the card the step then runs under the config's
    SGD. Returns a function that waits for the CPU and raises if the check
    fails."""
    future = pool.submit(_det_cpu_reference, dict(path=path, clip=clip))
    t0 = time.perf_counter()
    card = _det_pass(path, clip, 'cuda')
    model, cfg = card.pop('model'), Config.fromfile(DET + path)
    opt = build_optimizer(model, cfg.optimizer.to_dict(),
                          build_lr_schedule({}, cfg.optimizer['lr'], 1, 1),
                          grad_clip=(cfg.get('optimizer_config') or {})
                          .get('grad_clip'))
    loss = make_train_step(model, opt)(card.pop('on'))['loss'].item()
    if not math.isfinite(loss):
        raise AssertionError(f'{path}: step loss {loss}')
    card_s = time.perf_counter() - t0
    del model, opt

    def held():
        cpu = future.result()
        err = dict(
            score_share=_share(card['scores'], cpu['scores']),
            loss_diff=abs(card['loss'] - cpu['loss']),
            grad_rel=max(((a - b).norm() / b.norm()).item()
                         for a, b in zip(card['grads'], cpu['grads'])),
            card_s=card_s, cpu_s=cpu['seconds'], loss=card['loss'])
        if not (err['score_share'] <= RC_LOGIT_TOL and
                err['loss_diff'] <= RC_LOSS_TOL and
                err['grad_rel'] <= RC_GRAD_TOL):
            raise AssertionError(f'{path}: card vs CPU {err}')
        return err
    return held


def _det_eval(model, cfg, ava):
    """forward_test on every keyframe (the test-mode clip: the keyframe's
    4 x 16 frames, short side 256) over its proposals, then
    AVADataset.evaluate: mAP@0.5IOU in [0, 1]. Returns the metrics, the
    keyframes' (roi features, rois, metas, the first one's clip) for the
    LFB pass and the keyframes a second."""
    from mscl_torch.datasets import build_dataset
    pipeline = [dict(type='SampleAVAFrames', clip_len=4, frame_interval=16,
                     test_mode=True),
                dict(type='RawFrameDecode'),
                dict(type='Resize', scale=(-1, 256)),
                dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375], to_bgr=False),
                dict(type='FormatShape', input_format='NCTHW',
                     collapse=True)]
    ds = build_dataset(dict(cfg.data.train.to_dict(), ann_file=ava['ann'],
                            exclude_file=ava['exclude'],
                            proposal_file=ava['proposals'],
                            data_prefix=ava['prefix'], pipeline=pipeline,
                            test_mode=True))
    model.eval()
    results, feats = [], []
    t0 = time.perf_counter()
    for i in range(len(ds)):
        item = ds[i]
        h, w = item['img_shape']
        props = item['proposals']
        rois = torch.from_numpy(np.concatenate(
            [np.zeros((len(props), 1), np.float32), props], 1)).cuda()
        imgs = torch.from_numpy(item['imgs'][None]).cuda()
        with torch.no_grad():
            scores = model.forward_test(imgs, rois)
            roi_feats = model.roi_extractor(model.extract_feat(imgs), rois)
        results.append(dict(bboxes=props / np.array([w, h, w, h],
                                                   np.float32),
                            scores=scores.cpu().numpy()))
        feats.append((roi_feats, rois, [dict(img_key=ds.img_key(i))],
                      imgs if i == 0 else None))
    per_s = len(ds) / (time.perf_counter() - t0)
    metrics = ds.evaluate(results)
    if not 0 <= metrics['mAP@0.5IOU'] <= 1:
        raise AssertionError(f'AVA mAP {metrics}')
    return metrics, feats, per_s


def _det_lfb(root, feats):
    """The LFB end to end: LFBInferHead over the keyframes' RoI features
    writes lfb_train.pkl; LFB loads it and samples each RoI's long-term
    block (window 60 x 5 features of 2048, a seeded generator); the
    lfb_nl model (seed 1) runs forward_test with it on the first
    keyframe's clip and RoIs."""
    from mscl_torch.models.heads import LFB, LFBInferHead, sample_lfb
    prefix = osp.join(root, 'lfb')
    infer = LFBInferHead(prefix, dataset_mode='train')
    for roi_feats, rois, metas, _ in feats:
        infer(roi_feats, rois, metas)
    path = infer.save()
    cfg = Config.fromfile(DET + DET_LFB)
    lfb_cfg = dict(cfg.model.roi_head.shared_head.lfb_cfg.to_dict(),
                   lfb_prefix_path=prefix, dataset_modes=('train',))
    bank = LFB(**lfb_cfg)
    _, rois, metas, imgs = feats[0]
    lt = sample_lfb(bank, [metas[0]['img_key']] * len(rois),
                    np.random.default_rng(0))
    if lt.shape != (len(rois), 300, 2048) or not np.abs(lt).sum() > 0:
        raise AssertionError(f'LFB block {lt.shape}')
    model, _ = _det_model(DET_LFB, 'cuda')
    model.eval()
    with torch.no_grad():
        scores = model.forward_test(imgs, rois, torch.from_numpy(lt).cuda())
    if scores.shape != (len(rois), 81) or not torch.isfinite(scores).all():
        raise AssertionError(f'FBO forward_test {tuple(scores.shape)}')
    return dict(bank_videos=len(bank), lt_shape=list(lt.shape),
                pkl_bytes=os.path.getsize(path))


def _roi_align_cost(dev, n=8, hw=16, c=2048, rois=256, out=8, ratio=2):
    """RoIAlign at the AVA step's shape (8 clips' 16x16 maps of 2048,
    256 RoIs, 8x8 bins of 2x2 points): forward and backward ms (CUDA
    events, the mean of 5 after 2 warm-ups) and the peak memory above the
    inputs of one forward and backward."""
    from mscl_torch.ops.roi_align import roi_align
    g = torch.Generator(device=dev).manual_seed(0)
    feat = torch.rand(n, hw, hw, c, device=dev, generator=g) \
        .requires_grad_()
    xy = torch.rand(rois, 2, device=dev, generator=g) * 160
    boxes = torch.cat([torch.randint(0, n, (rois, 1), device=dev,
                                     generator=g).float(), xy,
                       xy + 32 + torch.rand(rois, 2, device=dev,
                                            generator=g) * 64], 1)
    cot = torch.rand(rois, out, out, c, device=dev, generator=g)

    def run():
        y = roi_align(feat, boxes, out, 1 / 16, ratio, True)
        y.backward(cot)
        feat.grad = None
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        run()
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / 5,
                peak_extra_bytes=torch.cuda.max_memory_allocated() - base,
                shape=[n, hw, hw, c, rois, out, ratio])


def phase_detection(root):
    """AVA spatio-temporal detection at the shipped configs' full widths on
    an AVA-shaped set written from a seed (csv, proposal pickle with
    scores, exclude file, JPEG rawframes at 320x240): card against CPU for
    the distinct models (DET_CHECKED: forward and one step, dropout 0) in
    the reference workers; every other config (DET_FORWARD) built and one
    forward on the card; the SlowOnly-50 config through the training CLI
    (batch 8, 4x16 frames, 256 crops, 32 RoIs a clip, DET_STEPS steps);
    forward_test on the keyframes into AVADataset.evaluate; the LFB end to
    end. No kernel of the port launches."""
    dev = torch.device('cuda')
    t_phase = time.perf_counter()
    root = osp.join(root, 'detection')
    os.makedirs(root)
    t0 = time.perf_counter()
    ava = _util('_torch_ava_util').write_ava_set(
        root, _jpeg_writer(), n_videos=DET_VIDEOS, keyframes=DET_KEYFRAMES,
        hw=(240, 320), distinct=16)
    write_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    pending, forward = {}, {}
    with reference_pool(root) as pool:
        for label, path in DET_CHECKED:
            cfg = Config.fromfile(DET + path)
            pending[label] = _det_card_vs_cpu(pool, path, _det_clip(cfg,
                                                                    ava))
        for path in DET_FORWARD:
            clip = _det_clip(Config.fromfile(DET + path), ava)
            model, _ = _det_model(path, dev)
            model.eval()
            with torch.no_grad():
                scores = model.forward_test(
                    torch.from_numpy(clip['imgs']).to(dev),
                    torch.from_numpy(clip['rois']).to(dev))
            if not torch.isfinite(scores).all():
                raise AssertionError(f'{path}: forward {scores}')
            forward[path] = list(scores.shape)
            del model
        checked = {label: held() for label, held in pending.items()}
    cvc_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    work = osp.join(root, 'work')
    torch.cuda.reset_peak_memory_stats()
    (runner, model), launches, run_s = cli_run(
        train_cli.main, [DET_MAIN, '--seed', '0', '--cfg-options',
                         *_det_options(ava, work)])
    row = dict(_cli_row(runner, work, 'imgs', 'detection_slowonly'),
               run_s=run_s, peak_bytes=torch.cuda.max_memory_allocated())
    if row['steps'] != DET_STEPS:
        raise AssertionError(f'detection: {row["steps"]} steps')
    t0 = time.perf_counter()
    metrics, feats, keyframes_per_s = _det_eval(model, Config.fromfile(
        DET_MAIN), ava)
    eval_s = time.perf_counter() - t0
    del runner, model
    t0 = time.perf_counter()
    lfb = _det_lfb(root, feats)
    lfb_s = time.perf_counter() - t0
    roi_align_cost = _roi_align_cost(dev)
    launches['corr_lookup'] = cl.corr_lookup.launches
    if any(launches.values()):
        raise AssertionError(f'detection launched {launches}')
    seconds = time.perf_counter() - t_phase
    log(phase='detection', train=row, card_vs_cpu=checked, forward=forward,
        metrics=metrics, keyframes_per_s=keyframes_per_s, lfb=lfb,
        roi_align=roi_align_cost,
        write_s=write_s, card_vs_cpu_s=cvc_s, eval_s=eval_s, lfb_s=lfb_s,
        seconds=seconds, launches=launches)
    log(phase='detection', headline=dict(
        checks=f'{len(DET_CHECKED)} models card vs CPU (forward and a '
               f'step), {len(DET_FORWARD)} more built and run; '
               f'slowonly_r50 trained ({DET_STEPS} steps at 8, 32 RoIs), '
               f'evaluated (mAP@0.5IOU), the LFB end to end; 0 kernel '
               f'launches',
        slowonly_r50=[round(row['steady_ms'], 1),
                      round(row['data_wait_ms'], 1),
                      round(row['device_ms'], 1),
                      round(row['idle_share'] or 0, 3),
                      round(row['peak_bytes'] / 2 ** 30, 2)],
        keys='steady_ms, data_wait_ms, device_ms and idle_share (a step '
             'profiled), peak_GiB',
        map=round(metrics['mAP@0.5IOU'], 4),
        roi_align_ms=round(roi_align_cost['ms'], 2),
        roi_align_peak_GiB=round(roi_align_cost['peak_extra_bytes'] /
                                 2 ** 30, 2),
        worst_share=_short(max(c['score_share']
                               for c in checked.values())),
        worst_grad=_short(max(c['grad_rel'] for c in checked.values())),
        parts_s=dict(write=round(write_s, 1), cvc=round(cvc_s, 1),
                     train=round(run_s, 1), eval=round(eval_s, 1),
                     lfb=round(lfb_s, 1))))


def _kernel_class(name):
    """Class of a device kernel by its name; the first match wins, so BN
    and resize kernels that cuDNN or a conv-like name carries come first."""
    n = name.lower()
    for cls, keys in (('decayed_infonce', ('l_neg_kernel', 'dq_partial',
                                           'dq_reduce')),
                      ('corr_lookup', ('corr_lookup',)),
                      ('batch_norm', ('bn_fw', 'bn_bw', 'batch_norm',
                                      'batchnorm')),
                      ('upsample', ('upsample',)),
                      ('conv', ('conv', 'xmma', 'implicit', 'wgrad', 'dgrad',
                                'fprop', 'cudnn')),
                      ('gemm', ('gemm', 'gemv', 'cutlass')),
                      ('reduce', ('reduce',))):
        if any(k in n for k in keys):
            return cls
    return 'elementwise_other'


def profile(path, fn):
    """Device time by kernel class over one more call of a path, and the
    device's busy share of that call's wall time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(path, prof, wall_ms)


def profile_summary(path, prof, wall_ms):
    """``profile``'s line and summary from a finished profiler."""
    by_class, top = {}, []
    for e in prof.key_averages():
        if getattr(e, 'device_type', None) != torch.autograd.DeviceType.CUDA:
            continue
        us = device_us(e)
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_class.values())
    top.sort(reverse=True)
    summary = dict(wall_ms=wall_ms, device_busy_ms=busy,
                   device_idle_share=(1 - busy / wall_ms) if busy else None)
    log(phase='profile', path=path, **summary,
        by_class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(ms=ms, count=n, name=k) for ms, n, k in top[:12]])
    return summary


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    os.makedirs(osp.dirname(LOG_PATH), exist_ok=True)
    sys.stdout.flush()
    saved = os.dup(1)
    with open(LOG_PATH, 'w') as f:
        os.dup2(f.fileno(), 1)
    out = os.fdopen(os.dup(saved), 'w', buffering=1)
    try:
        rows, corr, mxu, mxu_launches, cli_launches, corr_launches = \
            run_phases(out)
    except BaseException:
        sys.stdout.flush()
        with open(LOG_PATH, errors='replace') as f:
            tail = f.read()[-8000:]
        print(f'chip_smoke: failed; the end of {LOG_PATH}:\n{tail}',
              file=out)
        raise
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
        out.close()
    return main_result(rows, corr, mxu, mxu_launches, cli_launches,
                       corr_launches)


def run_phases(out):
    """Every phase in order; a summary line of each on ``out``."""
    dev = torch.device('cuda')
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        first = len(_RECORDS)
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(phase='phase_seconds', name=name, seconds=seconds[name])
        print(phase_summary(name, seconds[name], _RECORDS[first:]),
              file=out)
        return result

    t0 = time.perf_counter()
    reference_workers()          # they start beside the build
    cuda_build.build(cuda_build.all_sources())
    for name in cuda_build.host_sources():
        if cuda_build.load_host(name.rsplit('.', 1)[0]) is None:
            raise RuntimeError(f'no host compiler for csrc/{name}')
    log(phase='build', sources=cuda_build.all_sources(),
        host_sources=cuda_build.host_sources(),
        seconds=time.perf_counter() - t0)
    print(phase_summary('build', time.perf_counter() - t0, _RECORDS[-1:]),
          file=out)

    rows = run('kernels', phase_kernels, dev)
    corr = run('corr_lookup', phase_corr_lookup, dev)
    mxu = run('mxu_fill', phase_mxu_fill, dev)
    mxu_launches = run('mxu_fill_tool', phase_mxu_fill_tool)
    run('conv_yardstick', phase_conv_yardstick, dev)
    run('ssl_aug', phase_ssl_aug, dev)
    run('card_vs_cpu', phase_card_vs_cpu)
    run('recognizer3d_card_vs_cpu', phase_recognizer3d_card_vs_cpu)
    run('raft_card_vs_cpu', phase_raft_card_vs_cpu)
    run('flagship_float32', phase_flagship, dev, torch.float32)
    run('flagship_bfloat16', phase_flagship, dev, torch.bfloat16)
    corr_launches = run('flow_extraction', phase_flow_extraction)
    root = tempfile.mkdtemp(prefix='mscl_chip_smoke_')
    try:
        cli_launches, thread_window, pkls, pretrain_ckpt = run(
            'pretrain_cli', phase_pretrain_cli, root)
        run('pretrain_cli_process', phase_pretrain_cli_process, root, pkls,
            thread_window)
        run('pretrain_dp', phase_pretrain_dp, root, pkls)
        ft_pkls, ft_work = run('finetune_cli', phase_finetune_cli, root,
                               pretrain_ckpt)
        run('test_cli', phase_test_cli, ft_pkls, ft_work)
        run('retrieval_cli', phase_retrieval_cli, root, ft_pkls,
            pretrain_ckpt)
        run('readme_jpeg', phase_readme_jpeg, root)
        run('flow_tooling', phase_flow_tooling, root)
        rc_root, rc_sets = run('recognition_configs',
                               phase_recognition_configs, root)
        run('recognition_2d', phase_recognition_2d, rc_root, rc_sets)
        run('recognition_3d_zoo', phase_recognition_3d_zoo, rc_root,
            rc_sets)
        run('recognition_extern', phase_recognition_extern, rc_root,
            rc_sets)
        run('pretrain_configs', phase_pretrain_configs, dev, root, pkls)
        run('ablation_arms', phase_ablation_arms, dev, root)
        run('mscl_family', phase_mscl_family, dev, root, pkls, ft_pkls,
            ft_work)
        run('localization', phase_localization, root)
        run('audio', phase_audio, root)
        run('detection', phase_detection, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        stop_reference_workers()
    log(phase='phase_seconds', total=sum(seconds.values()), **seconds)
    print(json.dumps(dict(phase='all', s=round(sum(seconds.values()), 1),
                          log=osp.relpath(LOG_PATH))), file=out)
    return rows, corr, mxu, mxu_launches, cli_launches, corr_launches


def main_result(rows, corr, mxu, mxu_launches, cli_launches,
                corr_launches):
    # the TPU functions that reach pl.pallas_call, and the row of each
    # kernel at the shape its main path gives it
    rows.append(dict(corr['extraction_16x22'], name='corr_lookup'))
    replaces = {'decayed_infonce_l_neg': 'mscl_tpu/ops/decayed_infonce.py:62',
                'decayed_infonce_dq': 'mscl_tpu/ops/decayed_infonce.py:86',
                'corr_lookup': 'mscl_tpu/ops/corr_lookup.py:336 '
                               '(corr_lookup_pallas_v2) and '
                               'mscl_tpu/ops/corr_lookup.py:198 '
                               '(corr_lookup_pallas)'}
    counts = {'decayed_infonce_l_neg': cli_launches['l_neg'],
              'decayed_infonce_dq': cli_launches['dq'],
              'corr_lookup': corr_launches}
    sources = {'decayed_infonce_l_neg': 'mscl_torch/csrc/decayed_infonce.cu',
               'decayed_infonce_dq': 'mscl_torch/csrc/decayed_infonce.cu',
               'corr_lookup': 'mscl_torch/csrc/corr_lookup.cu'}
    for name, _, _ in MXU_ROWS:
        kind = name[len('mxu_fill_'):]
        rows.append(mxu[name])
        replaces[name] = ('tools/analysis/bench_mxu_fill.py:'
                          f'{MXU_REPLACES[kind]}')
        counts[name] = mxu_launches[kind]
        sources[name] = 'mscl_torch/csrc/mxu_fill.cu'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({'kernels': [dict(
        name=r['name'], route='cuda', source=sources[r['name']],
        replaces=replaces[r['name']], launches=counts[r['name']],
        max_abs_err=r['max_abs_err'], ms=r['kernel_ms'],
        plain_ms=r['plain_ms'],
        bound_ms=r['bound_ms'], bound_by=r['bound_by'],
        library_ms=r['library_ms']) for r in rows]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
