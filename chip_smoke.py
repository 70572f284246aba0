#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main paths on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. The card's name and power limit; the build of the kernels
   (``multimodal_baby_tpu_torch/ops/csrc/*.cu``) with nvcc, and ptxas's
   registers, spills and stack of each kernel (K5's, K8a's and K8b's
   ``attention_mma``, K7's ``vit_block_kernel`` and K8c's
   ``qkv_attention_mma`` named, each in its one-pass and two-pass form,
   with their shared memory at N = 257; the ``vit_gemm`` Dense tile with
   K5's two epilogues and the probe's GELU forms; K6's ``vit_pingpong``
   tile in its three GELU forms (fc1) and with the residual (fc2), with
   its launch geometry at the ViT slice's shape and any ptxas warning
   about its wgmma; K10b's ``bottleneck_fused`` in its four group widths,
   and its band geometry at layer 2's head; the 1x1 convolutions' tile of
   K1, K11 and the bf16 stage kernel, ``conv_gemm`` in its three epilogues
   and K11's, ``stage_tile_kernel`` in bf16, int8 (K3a's int8 stages and
   the banded int8 stage) and int8 transport (K10a's stages) in its four
   group widths each, K2's and K3a's int8 1x1 tile, ``conv_gemm_s8`` in its
   three epilogues, K10a's three 1x1 launches, ``conv_gemm_t`` (conv1 on
   the codes, conv3 with the residual or the downsample), and K1's and
   K2's grouped 3x3 on their halo tiles, ``gconv_halo`` and
   ``gconv_halo_s8``, in their four: the phase fails if ptxas reports
   spills or a serialized wgmma there).
2. K1 (``fused_bottleneck``) against its plain PyTorch version on the
   same bf16 inputs with the same rounding points, for four small and
   odd-sized cases at B = 8 and the 8 distinct ResNeXt-50 block shapes at
   224 px and B = 128: max error relative to the largest output <= 1e-2,
   cosine >= 0.9999 (the bf16 words that differ are counted). Then the
   time of each version at B = 128 (CUDA events; the plain version
   computes in f32 with TF32 off), of the cuDNN bf16 channels-last conv
   chain on the same folded weights (the library call), and the bound of
   each launch; a forward's bound is the sum of its launches' (here and
   for K2, K3a, K3b, K10a and K11).
2b. K5 (``fused_block_attention``) and K6 (``fused_mlp``) against their
   plain versions, with the same gates: small and odd cases at B = 2
   (N = 10 with kv_valid = 7, and N = 17; C = 256, 4 heads, F = 1024),
   then the ViT-B/14 shapes at B = 128 (N = 257, C = 768, 12 heads,
   F = 3072), timed beside their plain versions, the library calls
   (LayerNorm, Linear, scaled_dot_product_attention or GELU, Linear and
   the residual, in bf16) and the bound; then K5 at C = 768 and B = 2 (a
   ragged row count, M = 514) at N = 257, 400 and 752, each with and
   without kv_valid = N - 5 (one pass, then two passes of the attention
   core); K6 in every GELU form at ragged row counts of its 128-row tiles,
   (B, N) = (2, 257), (3, 400) and (1, 752) at C = 768, F = 3072, and under
   one tile (M = 5, C = 256, F = 512); and K6's two Denses alone at the
   ViT-B shape (``mmb_vit_mlp_dense_bf16``, fc1 with the erf GELU, fc2
   with the residual), their time and TFLOP/s.
2c. K2 (``fused_bottleneck`` on int8), K3a (``fused_stage``) and K3b
   (``fused_stage_banded``) against their plain versions: small and odd
   cases at B = 32 (8x8 and 7x7 px, as tests/test_quant_trunk.py; K2 also
   at Cin = 64) and at ragged row counts (B = 2, 9 -> 5 and 7 x 7 px: K2
   and an int8 stage with a stride-2 head), then every shape the
   published plan gives them at 224 px and B = 128: K2 on the four int8
   block shapes of layers 3-4, K3a on the layer-3 tail and on layer 4 in
   int8 and in bf16, K3b on layer 1 with N = 28 rows. int8 gate: codes at
   most 1 apart and fewer than 1e-3 of them differing (the count is
   printed; 0 is expected: the tiles sum exactly and round as the plain
   version); bf16 gate as K1. Each main-path
   shape is timed beside its plain version, a library chain
   (torch._int_mm 1x1 GEMMs, the cuDNN grouped 3x3 on the bf16 codes and
   elementwise requantization for int8; cuDNN bf16 convolutions for
   bf16) and its bound (int8 at 1979 TOP/s). Each stage (K3a's and
   K3b's bf16 body on K1's 1x1 tile, K3a's int8 body on K2's) also equals
   its blocks' K1 or K2 launches bit for bit (the count of differing
   words or codes is printed; 0 is required), so every band count gives
   the same values.
3. The ResNeXt slice in the per-block plan: the flagship CVCL (ResNeXt-50
   at full width with seeded random weights and BN statistics, flat 512-d
   head, embedding text encoder, fixed T = 0.07, running BN) with
   ``trunk_int8=False`` and ``fused_plan=("blocks",) * 4``, 3 AdamW train
   steps at B = 128 on 224x224 uint8 frames with the augment on, then one
   eval step. Checks: finite losses, 16 K1 launches per forward, trunk
   parameters bit-unchanged, heads changed. The eval forward's pooled
   features and logits against the plain bf16 conv path on the same
   weights: per-row cosine >= 0.999; the cosine against the f32 conv path
   (TF32 off) is printed. Then the step time and the trunk time of both
   paths.
4. The ViT slice: the ViT flagship CVCL (DINO ViT-B/14 at full width and
   depth in bf16, seeded trunc-normal(0.02) Dense weights, LayerNorm
   scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1), the 1-layer transformer
   text encoder with a learned pos-embed), 3 AdamW train steps at B = 128
   with the augment and the text dropout on, then one eval step. Checks:
   finite losses, 12 K5 and 12 K6 launches per forward, every ViT tensor
   bit-unchanged, the head and the text encoder changed. The eval CLS
   features and logits against the plain bf16 blocks on the same
   weights: per-row cosine >= 0.999; the cosine against the f32 plain
   blocks is printed. Then the ViT forward time of both paths, the step
   time and pairs/s.
2d. K7 (``fused_vit_block``), K8a (``fused_attention``), K8b
   (``fused_attention_pairs``) and K8c (``fused_qkv_attention_pairs``)
   against their plain versions on phase 2b's cases, with 2b's gates; K6
   and K7 also in the tanh and sigmoid GELU forms; K7 against K5 then K6
   bit for bit in every form (the count of differing bf16 words is
   printed), also at 2b's ragged and two-pass cases; then K8a and K8b (on
   the column slices of a [B, N, 3C]
   tensor) at N = 257, 272, 273, 416 and 752 and K8c at the first four (B
   = 2, C = 768), each with and without kv_valid = N - 20:
   the edges of their register-resident design (one chunk of 272 keys,
   then two passes). Each ViT-B case is timed beside its plain version, its
   library call (scaled_dot_product_attention for K8a and K8b; Linear and
   scaled_dot_product_attention for K8c; 2b's LayerNorm / Linear / SDPA /
   GELU chain for K7, and K5 then K6) and its bound.
5. The published flagship (``bench.py:102-121``): phase 3's model with
   ``trunk_int8=(False, False, True, True)`` and the default plan
   ``("banded28", "blocks", "split", "full")``, calibrated once on 32
   augment-off frames, then 3 AdamW train steps and 1 eval step at
   B = 128. Checks: finite losses; per forward 4 K1, 1 K2, 2 K3a and 1
   K3b launches; trunk tensors and amax buffers bit-unchanged, heads
   changed; the eval pooled features and logits against the same plan run
   through the plain versions on the card: per-row cosine >= 0.999; the
   pooled features against the f32 conv path: per-row cosine > 0.99 (the
   JAX package's gate, tests/test_quant_trunk.py:188-220). Then the trunk
   forward time of the int8 plan, the bf16 per-block K1 path and the
   plain bf16 conv path, the step time and pairs/s.
6. The ViT slice of phase 4 (the same model, switched through the trunk's
   ``vit_kernels``) in each further kernel configuration: ``attn="1"``
   (K8a), ``"pairs"`` (K8b), ``"qkv"`` (K8c), ``whole_block=True`` (K7)
   and ``gelu="tanh"`` (K5, K6): 3 AdamW train steps and 1 eval step each
   at B = 128. Checks: finite losses; per forward 12 launches of the
   configuration's kernels (12 K6 beside each K8, no K5 or K6 beside K7)
   and none of the others; ViT tensors bit-unchanged, heads changed; eval
   CLS and logits against the same configuration with its kernels
   swapped for their plain versions on the card and against the plain
   bf16 blocks: per-row cosine >= 0.999 (the cosine against f32 is
   printed). The opt-in modes too: ``int8=True``, ``lnfold=True``, both,
   and ``lnfold=True, attn="qkv"`` (12 K8b launches a forward, or 12 K8c
   on the folded weights, and no K5, K6 or K7). int8 is gated instead by
   its CLS against the f32 plain path of the default configuration and
   against its plain versions on the card (per-row cosine >= 0.99 each,
   the JAX package's envelope: a bf16 rounding that a kernel moves can
   move an int8 code, which the later blocks carry), printing its
   decisions against the plain versions' and its sensitivity to a
   one-ulp change of 1% of the pixels; LN-fold without int8 also by its
   CLS against the default configuration's (per-row cosine >= 0.999).
   Then the ViT forward and step time of each, and the step times of the
   default, attn=1, attn=pairs, attn=qkv, whole_block and the four opt-in
   modes in turns (the list, then the list reversed), each from phase 4's
   weights.
2e. K9 (``lstm_fused``) against the plain scan at (B, L, H) = (128, 25,
   512) and (128, 64, 512) with random lengths (max absolute error <= 1e-4
   on out, h_last and c_last; a repeated call gives the same bits), and
   K4's forward and backward (``fused_infonce_forward``,
   ``fused_infonce_backward``) against their plain versions at B = 128 and
   1024, E = 512, on unit-norm rows at T = 0.07 (loss relative error
   <= 1e-5, LSEs absolute 1e-5, accuracies exact, entropies relative 1e-4,
   gradients atol 1e-4 and rtol 1e-3 of autograd through the plain loss; a
   repeated forward and backward give the same bits). Each timed beside
   its plain version (f32, TF32 off) and its library call (cuDNN nn.LSTM
   over the packed embeddings, which also projects the inputs: that GEMM is
   timed alone and taken out of the row's library time; torch.matmul with
   two F.cross_entropy calls, forward and autograd backward), every event
   time printed beside the profiler's device time, and its bounds: f32 at
   67 TFLOP/s (the row's) and, beside it, three TF32 tensor-core products
   at 495 TFLOP/s, as the kernels run them.
7. The LSTM text encoders on phase 5's calibrated published trunk, at
   B = 128, vocab 2350, E = H = 512, augment on. (a) The LSTM contrastive
   recipe (dropout_i 0.5, lambda_mm 1), 3 train steps and 1 eval step from
   the same weights with ``fused_lstm=None`` (the JAX length rule: no K9 at
   L = 25) and ``fused_lstm=True`` (one K9 launch per forward): eval text
   features per-row cosine >= 0.9999 and logits >= 0.999 between the two;
   ``infonce_loss`` (K4, forward and backward) on the eval features equals
   the eval step's infonce_loss to rtol 1e-5, its gradients those of
   autograd through the plain loss (atol 1e-4, rtol 1e-3); a biLSTM
   encoder's eval forward: exactly 2 K9 launches, features against the
   plain scan cosine >= 0.9999. (b) The joint recipe (lambda_mm = lambda_lm
   = 0.5, tied head with bias, ``fused_lstm=True``): 3 train steps and 1
   eval step with the LM cross-entropy and its breakdown printed, then
   beam search over 8 sequences, width 3, length 25, timed. (c) The LM
   recipe (lambda_mm 0: no image forward) at L = 64 with
   ``fused_lstm=None``: the length rule picks K9, one launch per forward.
   Each run: finite losses, trunk bit-unchanged, heads changed, step time.
2f. K10a, the int8-transport mode (``fused_bottleneck``, ``fused_stage``,
   ``fused_stage_banded`` with ``fold_block_params_t`` weights), K10b
   (``fused_bottleneck_tiles``) and K11 (``conv1x1_bn_residual_relu``)
   against their plain versions at B = 128: K10a on the blocks of the "t"
   plan (layer 2's head and tail, layer 3's head) at most 1 code apart and
   fewer than 1e-3 of the codes differing, its stages (layer 3's tail,
   layer 4, layer 1 banded at N = 28) equal to their blocks' K10a launches
   code for code, each of those in the same envelope against its plain
   version on the same input, the whole at cosine >= 0.9999 against the
   plain chain (a moved code rides the residual path on; the count is
   printed); K10b (one launch a call) at tests/test_hwbc_kernels.py:74's
   shape, the 8 ResNeXt-50 block shapes at B = 8 and layer 2's head at B
   = 128 against its plain version (phase 2's gates) and against K1
   (< 5e-5 relative, tests/test_hwbc_kernels.py:22; the share of outputs
   that differ and the largest difference in bf16 ulps printed), timed at
   layer 2's head beside K1 (before and after the turns); K11 at every conv3
   shape of a forward (phase 2's gates), its gradients at layers 1 and 4
   equal to the plain version's autograd. Each timed beside its plain
   version, its library chain (the codes in bf16 through cuDNN, then the
   output scale and rounding; cuDNN's block; bf16 matmul and the f32
   epilogue) and its bound (K10a's activations at one byte); each K10a
   block beside K1 at the same block shape, each K10a stage beside the
   bf16 body at the same stage (K3a, or K3b at the same band).
2g. K12 (``ops/batch_norm.py``: BatchNorm on batch statistics as a
   statistics launch and an apply launch) at the 16 shape classes of the
   53 batch-statistics BatchNorms of a B = 512 train-mode forward (the
   stem, bn1 and bn2 with ReLU, bn3 with the identity or the downsample's
   BatchNorm fused in): through ``InferenceBN.forward_relu`` against the
   plain path (``InferenceBN``'s body, the residual add and ReLU; phase
   2's gates), its fold within 1e-5 of the plain version's, two calls
   equal bit for bit, one apply launch a call; timed in turns beside the
   plain path and ``F.batch_norm`` (the library yardstick only), each
   K12's also as CUDA-graph replays (device time without the host's
   launch path), against the bytes bound. Then one train-mode (batch
   statistics) forward of a frozen bf16 ResNeXt-50 at B = 512 and 224 px,
   the conv path K12 serves, with the launch counters set to 0 before it:
   53 statistics and 49 apply launches, as counted there. Alone (it
   builds the kernels at its first launch): ``python3 -c "import
   chip_smoke; chip_smoke.phase_batch_norm()"``.
8. The int8-transport plans: phase 5's model with ``trunk_int8="t"`` and
   ``("t", "t", "q", "q")``, calibrated once, 3 AdamW train steps and 1
   eval step each at B = 128. Checks: finite losses; per forward "t": 5
   K10a block, 2 K10a stage and 1 K10a banded launches, "t,t,1,1": 4
   K10a block, 1 K10a banded, 1 K2 and 2 K3a, and no other; trunk
   bit-unchanged, heads changed; eval pooled features and logits against
   the same plan through the plain versions (per-row cosine >= 0.999) and
   pooled against the f32 conv path (> 0.99, tests/test_quant_trunk.py:
   295-331). Then the trunk forward and the step times of both plans and
   of phase 5's, in turns. 8c: the entry points of K10b
   (``fused_bottleneck_tiles`` on layer 2's head: one launch)
   and K11 (the conv path with ``BottleneckX(fused_epilogue=True)`` on all
   16 blocks: 16 launches per forward, pooled against the conv path
   without it at per-row cosine >= 0.999).

9. Forced-choice evaluation, the five-call API and the linear probe on
   the published trunk's kernels. 9a: phase 5's weights (no amax buffers,
   the tied LM weight added) written as a reference Lightning ``.ckpt``
   with its hparams, the packaged ``vocab.json`` beside it, loaded with
   ``load_model`` on the card (bf16, the default plan: K3b, K1, K3a);
   the five calls on ``tokenize(["ball", "a cat"])`` and 8 preprocessed
   frames: logits equal to logit_scale * image @ text.T (<= 1e-3), the
   default plan's launches for 2 forwards, and image features equal bit
   for bit to phase 5's model's at B = 8 (its int8 plan runs in bf16
   there). Before 9a, the ResNeXt's and the ViT's vision heads are
   fitted by least squares so that each category's mean f32 trunk
   feature maps to its label's text features (a random trunk's features
   of different frames lie within cosine ~0.9997, so a random head makes
   every trial a near-tie). 9b: 64 PNG frames at 224 px (16 coarse random
   textures, 4 noisy frames each, one per Labeled-S category) and 257
   trials in image and in text mode with <sos>/<eos> at ``batch_size=64``
   (the trunk sees B = 256, 256, 256, 256, 4 and B = 64, 64, 64, 64, 1),
   through the loaded model and phase 5's calibrated int8 model wrapped
   in ``CVCLModel``; each run against the same run under
   ``plain_kernels()`` and through the f32 conv path: the trunk's image
   features (pooled or CLS) per-row cosine >= 0.999 against the plain
   versions (the embeddings' cosine printed), equal decisions on
   every trial whose plain top-two logit gap exceeds 0.05 and on >= 99%
   of all trials, the agreement with f32 printed; K1, K2, K3a and K3b
   launches counted per chunk against the plan (int8 where B % 32 == 0,
   else bf16); trials/s per mode with and without PNG decoding. 9c:
   phase 4's ViT + transformer model through 65 image-mode trials (B =
   256, then 4: K5 and K6 at M = 4 * 257) with the same gates and 12 K5
   and 12 K6 launches per chunk. 9d: backbone features of 512 frames
   (16 classes) through the kernels (two chunks of 256 on the int8 plan)
   and their plain versions, per-row cosine >= 0.999; a probe trained on
   half of them for 5 epochs, its train and held-out accuracy printed.
10. The trainer (``cli/train.py``, ``train/trainer.py``) on the published
   recipe's flags (configs/_base.py:9-35, ``--frozen_bn running
   --trunk_int8 0,0,1,1``) at B = 128. 10a: 2 epochs of 512 synthetic
   pairs (4 steps an epoch). Checks: K1, K2, K3a and K3b launches [4, 1,
   2, 1] in every train step; finite losses; the per-step train losses
   within 1e-2 relative of the same run under ``plain_kernels()`` (the
   largest difference printed); ``last``, ``epoch_N``, ``index.json``,
   ``config.json``, ``metrics.jsonl`` and ``vocab.json`` written. Prints
   the step time from ``StepTimer`` (warmup 2) and pairs/s beside phase
   5's step, the peak device memory, and the time each epoch waited on
   the loader. 10b: ``--resume_ckpt last --max_epochs 3``: start_epoch 2
   and step 8; before the first resumed step the weights, the AdamW
   moments, the LR, the plateau and the generator state equal the saved
   ones bit for bit and the amax buffers after ``_recalibrate`` are
   within 1e-6 relative (the largest difference printed); step 12 after
   the third epoch, whose losses are within 1e-5 relative of an
   uninterrupted 3-epoch run's. 10c: a SAYCam-format directory (phase
   9b's 64 PNG frames, 512 train and 128 val utterances of packaged-vocab
   words with 2-4 frames each, 64 trials, the packaged vocab), one epoch
   with ``--multiple_frames --eval_include_sos_eos``: launches [4, 1, 2,
   1] per train step and in the validation's forced-choice chunk (B =
   256); then ``load_model(<checkpoint dir>)``: image features at B = 8
   equal to the trainer's model's bit for bit, and its forced-choice
   accuracy equal to the one the validation logged. Prints pairs/s with
   PNG decoding and the loader's wait.
11. Text generation, grad-CAM and the analyses that run a model, on the
   published trunk's kernels. 11a: the joint recipe
   (configs/saycam_joint.py: ``--text_encoder lstm --lambda_mm 0.5
   --lambda_lm 0.5 --eval_textgen``, beam 3, 25 steps, val batch 16) with
   phase 10's flags through ``cli/train.py``, one epoch of phase 10c's
   directory: launches [4, 1, 2, 1] in every train step, BLEU-1..4,
   METEOR, ROUGE_L, CIDEr and SPICE finite, and the same validation under
   ``plain_kernels()`` gives the same hypotheses (the unconditioned
   decode runs no trunk kernel); prints the decode's time a batch and
   sequences/s. 11b: a captioning LSTM on phase 5's calibrated trunk
   (its own seeded head), ``run_textgen_eval`` over phase 9b's 64 frames
   at B = 64 (the category names as references): [4, 1, 2, 1] launches,
   the trunk's features at per-row cosine >= 0.999 to
   ``plain_kernels()`` (the image features printed), sequences equal
   where the plain run's top two beam scores differ by more than 0.05;
   prints sequences/s and the encode/decode split. 11c: ``cli/eval.py
   --dump_attention_maps 8`` on phase 9a's checkpoint writes 32 overlays;
   ``grad_cam`` on those 8 trials (B = 4) launches the bf16 plan a trial
   and, on a seeded random head, reaches per-map cosine >= 0.999 to plain
   (the f32 conv path's agreement, and both on phase 9's fitted head,
   printed: that head's gain scales bf16 differences up);
   ``grad_cam_captioning`` on 11b's first frame and caption over 8
   steps: step 0 zero, maps in [0, 1], cosine >= 0.999 to plain. 11d: the
   alignment's feature sets over phase 9b's frames (one directory per
   category; ``category_feature_sets`` and the alignment CSVs) at per-row
   cosine >= 0.999 to plain, and the leak audit on 10c's directory, its
   eval frames' trunk features at >= 0.999 to plain; launches per chunk
   against the plan; prints the Pearson r. t-SNE and the audit's figures are host code the
   CPU tests hold (the card's machine has no scikit-learn or matplotlib).
   11e: ``collect_token_data`` over the directory's 640 utterances
   (``sentence_batches``, L = 25) on phase 7b's joint model with
   ``fused_lstm=True``: one K9 launch per ``lm_forward``, per-token
   cross-entropy within 1e-4 of the plain scan, hidden states at per-row
   cosine >= 0.9999; prints tokens/s.
12. The host input path, the host-only analysis chain and the sweep
   runner, on phase 10's checkpoint root and 10c's directory. 12a: the
   decoder that runs (the native C++ decoder, ``data/native``, built with
   g++ against libjpeg and libpng, or PIL with the build's error where it
   cannot be built) and ``os.cpu_count()``; 1,024 JPEGs made as
   ``bench.py::ensure_jpeg_dataset`` makes them (256 px, quality 90) and
   10c's PNG frames: with the native decoder, one ``decode_batch_checked``
   call over 128 paths equal byte for byte to ``decode_image`` frame by
   frame with the mask all ones, its exact mode within
   tests/test_native_pipeline.py's tolerance of PIL's bilinear resize
   (mean 2 u8) and 224 px PNGs equal to PIL's; frames/s of the native
   batch, the native per frame and PIL per frame, JPEG and PNG. 12b: 10c's
   recipe for one epoch on its PNG directory and on a JPEG copy (quality
   90), each again with the loader in ``sync`` mode: [4, 1, 2, 1]
   launches in every train step, every device batch equal to its host
   batch (frames, ids, lengths: the pinned staging ring of
   ``train/step.py::HostStaging``), the epoch's train losses equal bit for
   bit to the sync run's; prints pairs/s and the loader's share of the
   epoch. 12c: ``scripts/real_io_torch.py`` (1,024 JPEGs, 4 loader
   threads, prefetch 6, B = 128): [4, 1, 2, 1] launches a step, finite
   losses; prints pairs/s, the loader's wait, the host's staging time and
   the H2D rate of one batch's frames from pageable and from pinned
   memory. 12d: phase 9b's 257 image-mode trials from JPEG files of its
   frames through phase 9a's checkpoint (bf16 plan, batch 64): every
   decision equal to the decision on the same frames decoded first;
   prints trials/s. 12e: ``CheckpointRegistry`` over phase 10's root, its
   best entry's ``load`` equal bit for bit to ``from_checkpoint_dir``;
   ``cli/eval.py`` on 10c's checkpoint, then ``cli/analyze.py summaries``
   and ``descriptives`` on its predictions and directory (``figures`` where
   matplotlib is installed; which ran is printed); ``cli/runner.py
   --config configs.saycam_contrastive --dry_run`` lists the grid's jobs,
   and one job of ``--emit_scripts`` run on 10c's directory for one epoch
   at B = 128 exits 0.
13. The ETL and COCO, local backbone checkpoints and the distributed step
   (``phase_etl_coco_backbones_distributed``).
14. The opt-in modes of the kernel configuration
   (``models/kernel_config.py``). 14e: phase 5's calibrated published
   model with each stem (``conv7``, ``s2d``, the split stem, ``cpad``,
   ``s2d`` + ``cpad``): pooled features per row at cosine >= 0.999 to the
   default stem's, the stem's device time (torch.profiler, and CUDA
   events), one train step's launches (the plan's [4, 1, 2, 1]), then the
   train steps in turns. 14f: the augment's per-channel form against the
   default on the same draws at B = 128 (max error <= one bf16 ulp of the
   output's range), and the space-to-depth form against
   ``space_to_depth`` of the default; each timed. 14g:
   ``fused_bottleneck_diff`` at layer 1's head block (B = 32): its forward
   equal to K1's bit for bit, the gradients of x and every folded weight at
   cosine >= 0.9999 to plain autograd. 14h: ``cli/train.py`` for one epoch
   of synthetic pairs at B = 128: the ViT flagship with ``--vit_int8 1
   --vit_lnfold 1`` (12 K8b launches and no other ViT kernel a train step),
   and the published recipe with ``--split_stem 1`` (the plan's launches a
   step, the trunk fed 12 channels in training and validation).
15. The CLIP baseline (``evaluation/clip_baseline.py``) on the port's CLIP
   towers (``models/clip.py``), with random weights at the published
   widths written by the port's own writer in the Hugging Face layout
   (config.json, f16 model.safetensors, a byte-level vocab.json and
   merges.txt): ViT-L/14 (vision 24 x 1024, patch 14 at 224 px; text 12 x
   768, 77 positions, vocab 49408; projection 768) and ViT-B/16 (vision 12
   x 768, patch 16; text 12 x 512; projection 512). Both projections are
   first fitted by least squares on f32 features so that decisions are
   not near-ties. K5 and K6 (eps 1e-5, K6 in the sigmoid GELU form, CLIP's
   quick_gelu) against their plain versions with phase 2b's gates at the
   batches the path gives them (ViT-L/14: B = 64, N = 257, C = 1024, F =
   4096; ViT-B/16: B = 5 and 64, N = 197, C = 768, F = 3072), each timed
   per tower forward beside the plain versions, the library chain and the
   bound. 15a: ``load_clip`` of the ViT-L/14 directory onto the card,
   then ``run_clip_forced_choice`` over 64 four-way trials of 16
   textures (B = 64 images a batch): 24 K5 and 24 K6 launches per vision
   forward, image and text features at per-row cosine >= 0.999 to the f32
   plain path, decisions equal wherever the f32 top-two gap exceeds 0.05;
   trials/s and the encode split between images and text. 15b: the ETL's
   ``filter_eval_frames`` with its default scorer, the ViT-B/16 baseline
   read from the Hugging Face cache layout under a temporary HF_HOME, on
   22 categories of 5 JPEG frames (one of them another category's): 12 K5
   and 12 K6 launches per forward, and the same frames kept as by the f32
   plain scorer.

Prints one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.api.model import (
    PACKAGED_VOCAB, CVCLModel, load_model)
from multimodal_baby_tpu_torch.core.config import (
    DataConfig, ExperimentConfig, ModelConfig, TextConfig, TrainConfig,
    VisionConfig)
from multimodal_baby_tpu_torch.core.constants import MAX_LEN_UTTERANCE
from multimodal_baby_tpu_torch.data.augment import (
    apply_augment, augment_batch, normalize_image, sample_augment,
    space_to_depth)
from multimodal_baby_tpu_torch.data.datasets import (
    EvalTrialDataset, TextEvalTrialDataset, load_metadata)
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.evaluation.forced_choice import (
    run_forced_choice)
from multimodal_baby_tpu_torch.evaluation.linear_probe import (
    extract_backbone_features, half_split, probe_accuracy,
    train_linear_probe)
from multimodal_baby_tpu_torch.models import vision_resnext, vision_vit
from multimodal_baby_tpu_torch.models.beam_search import NEG_INF
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.losses import (
    contrastive_loss_from_logits)
from multimodal_baby_tpu_torch.models.multimodal import CVCL, l2_normalize
from multimodal_baby_tpu_torch.models.text import TextEncoder
from multimodal_baby_tpu_torch.models.vision_resnext import (
    DEFAULT_PLAN, RESNEXT50_STAGES, InferenceBN, ResNeXt50)
from multimodal_baby_tpu_torch.models.vision_vit import LayerNorm, ViTKernels
from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.attention import (
    MAX_TOKENS_QKV, attention_geometry, attention_pairs_reference,
    attention_reference, block_attention_reference, fused_attention,
    fused_attention_pairs, fused_block_attention, fused_qkv_attention_pairs,
    qkv_attention_pairs_reference)
from multimodal_baby_tpu_torch.ops.bottleneck import (
    BN_EPS, block_geometry, block_geometry_s8, block_reference,
    bottleneck_reference, default_band,
    fused_bottleneck, fused_bottleneck_diff, fused_bottleneck_tiles,
    tiles_geometry, tiles_reference)
from multimodal_baby_tpu_torch.ops.batch_norm import (
    batch_norm_apply, batch_norm_stats, batch_norm_stats_reference)
from multimodal_baby_tpu_torch.ops.conv_epilogue import (
    conv1x1_bn_residual_relu, epilogue_reference)
from multimodal_baby_tpu_torch.ops.infonce import (
    fused_infonce_backward, fused_infonce_forward,
    fused_infonce_with_metrics, infonce_backward_reference, infonce_loss,
    infonce_reference)
from multimodal_baby_tpu_torch.ops.lstm import lstm_fused, scan_reference
from multimodal_baby_tpu_torch.ops.quant import (
    bottleneck_reference_q, bottleneck_reference_t, fold_block_params_q,
    fold_block_params_t)
from multimodal_baby_tpu_torch.ops.stage import (
    fused_stage, fused_stage_banded, stage_reference)
from multimodal_baby_tpu_torch.ops.vit_block import (
    fused_vit_block, vit_block_reference)
from multimodal_baby_tpu_torch.ops.vit_common import GELU_MODES
from multimodal_baby_tpu_torch.ops.vit_mlp import (
    fused_mlp, mlp_geometry, mlp_reference)
from multimodal_baby_tpu_torch.train.step import (
    calibrate_trunk, init_train_state, make_eval_step, make_train_step)

BATCH = 128          # the slices' batch: the kernels are checked and timed at it
CHECK_BATCH = 8      # the batch of the small and odd-sized K1 checks
VOCAB = 2350
REL_TOL = 1e-2
COS_TOL = 0.9999
SLICE_COS_TOL = 0.999
TRAIN_STEPS = 3
TIMED_STEPS = 10
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores, at 700 W
PEAK_OPS_INT8 = 1979e12  # H100 SXM dense int8 tensor cores, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
Q_CHECK_BATCH = 32   # the int8 plans' batch multiple
MIXED = (False, False, True, True)  # bench.py:117

# (name, H, Cin, width, Cout, stride, downsample, blocks per forward)
BLOCKS_224 = [
    ("layer1.0", 56, 64, 128, 256, 1, True, 1),
    ("layer1.1", 56, 256, 128, 256, 1, False, 2),
    ("layer2.0", 56, 256, 256, 512, 2, True, 1),
    ("layer2.1", 28, 512, 256, 512, 1, False, 3),
    ("layer3.0", 28, 512, 512, 1024, 2, True, 1),
    ("layer3.1", 14, 1024, 512, 1024, 1, False, 5),
    ("layer4.0", 14, 1024, 1024, 2048, 2, True, 1),
    ("layer4.1", 7, 2048, 1024, 2048, 1, False, 2),
]
# correctness only: layer 4 at 64 px (4x4 -> 2x2), and odd spatial sizes
BLOCKS_EDGE = [
    ("layer4.0@64px", 4, 1024, 1024, 2048, 2, True, 0),
    ("layer4.1@64px", 2, 2048, 1024, 2048, 1, False, 0),
    ("odd 7->4 stride 2", 7, 512, 256, 512, 2, True, 0),
    ("odd 5x5 stride 1", 5, 256, 128, 256, 1, False, 0),
]
# K1's 1x1 tile (csrc/conv_gemm.cuh) in its three epilogues (the mangled
# ConvEpilogue<b2, residual>) and K11's
CONV_TILE_FORMS = {"ConvEpilogueILb0ELb0E": "conv1",
                   "ConvEpilogueILb1ELb0E": "conv3 with the downsample",
                   "ConvEpilogueILb0ELb1E": "conv3 with the residual",
                   "15ConvEpilogueMul": "K11"}
# (B, N, C, heads, F, kv_valid); the last is ViT-B/14 at the slice's batch
VIT_CASES = [(2, 10, 256, 4, 1024, 7), (2, 17, 256, 4, 1024, None),
             (BATCH, 257, 768, 12, 3072, None)]
# K5 (phase 2b) and K7 (phase 2d) also at ViT-B width with a ragged row
# count (B = 2: M = 514) and at two-pass lengths of the attention core, up
# to both kernels' cap of 752 tokens
VIT_LONG_CASES = [(2, n, 768, 12, 3072, kv) for n in (257, 400, 752)
                  for kv in (None, n - 5)]
# K6 (phase 2b) at ragged row counts of its 128-row tiles and under one
# tile: (B, N, C, F)
MLP_RAGGED_CASES = [(2, 257, 768, 3072), (3, 400, 768, 3072),
                    (1, 752, 768, 3072), (1, 5, 256, 512)]
VIT_DEPTH = 12
# the ViT kernel wrappers, by the TPU kernel each replaces
VIT_KERNELS = {"K5": fused_block_attention, "K6": fused_mlp,
               "K7": fused_vit_block, "K8a": fused_attention,
               "K8b": fused_attention_pairs, "K8c": fused_qkv_attention_pairs}
# phase 6: configuration -> (ViTKernels, launches per forward)
VIT_CONFIGS = {
    "attn=1": (ViTKernels(attn="1"), {"K8a": VIT_DEPTH, "K6": VIT_DEPTH}),
    "attn=pairs": (ViTKernels(attn="pairs"),
                   {"K8b": VIT_DEPTH, "K6": VIT_DEPTH}),
    "attn=qkv": (ViTKernels(attn="qkv"), {"K8c": VIT_DEPTH, "K6": VIT_DEPTH}),
    "whole_block": (ViTKernels(whole_block=True), {"K7": VIT_DEPTH}),
    "gelu=tanh": (ViTKernels(gelu="tanh"), {"K5": VIT_DEPTH,
                                            "K6": VIT_DEPTH}),
    # the opt-in modes: int8 or LN-fold skips K5, K6 and K7; attention
    # "block" then runs K8b, and "qkv" K8c on the folded weights
    "int8": (ViTKernels(int8=True), {"K8b": VIT_DEPTH}),
    "lnfold": (ViTKernels(lnfold=True), {"K8b": VIT_DEPTH}),
    "int8+lnfold": (ViTKernels(int8=True, lnfold=True), {"K8b": VIT_DEPTH}),
    "lnfold attn=qkv": (ViTKernels(lnfold=True, attn="qkv"),
                        {"K8c": VIT_DEPTH}),
}
# phase 6: the configurations whose step times are taken in turns
VIT_TURNS = {"default": ViTKernels(), "attn=1": ViTKernels(attn="1"),
             "attn=pairs": ViTKernels(attn="pairs"),
             "attn=qkv": ViTKernels(attn="qkv"),
             "whole_block": ViTKernels(whole_block=True),
             **{name: VIT_CONFIGS[name][0] for name in (
                 "int8", "lnfold", "int8+lnfold", "lnfold attn=qkv")}}
INT8_COS = 0.99       # the int8 ViT's CLS: the JAX package's envelope
DECISION_GAP = 0.05   # int8 decisions printed where the top-two gap exceeds it
# phase 2d: K8a-c at the edges of their register-resident design
# (N = 257 and 272: a row's scores in one chunk of registers; 273: the
# first N over it, two passes; K8c's cap 416, K8a's 752), with and without
# kv_valid: (B, N, C, heads, kv_valid)
K8_EDGE_CASES = [(2, n, 768, 12, kv) for n in (257, 272, 273, 416, 752)
                 for kv in (None, n - 20)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(ms, what bounds it): the larger of the two least times."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def launch_bound(total, flops, nbytes, count=1, peak=PEAK_FLOPS):
    """One launch's bound, added ``count`` times to a per-forward total: a
    forward runs its launches one after another, so its bound is the sum of
    theirs (``total["bound_ms"]``; ``total["bound_by"]`` names what bounds
    the launches that carry most of it). Returns the launch's (ms, by)."""
    ms, by = bound(flops, nbytes, peak)
    total["bound_ms"] = total.get("bound_ms", 0.0) + count * ms
    share = total.setdefault("bound_share", {"operations": 0.0, "bytes": 0.0})
    share[by] += count * ms
    total["bound_by"] = max(share, key=share.get)
    return ms, by


def cosine(a, b):
    # in f64: an f32 dot over the tens of millions of outputs of one block
    # at B = 128 is itself off in the fourth digit
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def row_cosines(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(kernel, plain, library, iters):
    """(kernel, plain, library) ms, timed plain, kernel, library, library,
    kernel, plain; each entry is the mean of its two turns."""
    p1, k1, l1 = (time_ms(plain, max(iters // 4, 2)), time_ms(kernel, iters),
                  time_ms(library, iters))
    l2, k2, p2 = (time_ms(library, iters), time_ms(kernel, iters),
                  time_ms(plain, max(iters // 4, 2)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def check(what, got, want) -> float:
    """A kernel's output against its plain version; returns the max abs
    error."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-12)
    cos = cosine(got, want)
    words = int((got != want).sum()) if got.dtype == want.dtype else -1
    log(f"  {what:34s} out {tuple(got.shape)}: max_abs_err {err:.4g} "
        f"rel {rel:.3e} cos {cos:.7f}, {words} of {got.numel()} words "
        f"differ")
    if not (math.isfinite(rel) and rel <= REL_TOL and cos >= COS_TOL):
        raise AssertionError(
            f"{what}: rel {rel:.3e} (<= {REL_TOL}) cos {cos:.7f} "
            f"(>= {COS_TOL})")
    return err


# ----------------------------------------------------------------- phase 2

def random_block(gen, H, cin, width, cout, stride, has_ds, batch):
    """bf16 post-ReLU input and folded weights of one block, on the card."""
    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in)
                ).to("cuda", torch.bfloat16)

    def b(n):
        return (0.1 * torch.randn(n, generator=gen)).to("cuda")

    fw = {"w1": w(cin, width, fan_in=cin), "b1": b(width),
          "w2": w(3, 3, width // 32, width, fan_in=9 * width // 32),
          "b2": b(width),
          "w3": w(width, cout, fan_in=width), "b3": b(cout)}
    if has_ds:
        fw["wd"] = w(cin, cout, fan_in=cin)
        fw["bd"] = b(cout)
    x = torch.randn(batch, H, H, cin, generator=gen).clamp_min(0.0)
    return x.to("cuda", torch.bfloat16), fw


def conv_chain(fw, stride):
    """The library call for K1: cuDNN bf16 convolutions, channels-last, on
    the same folded weights (biases in bf16)."""
    cl = torch.channels_last

    def conv_w(w):  # [in, out] -> [out, in, 1, 1]
        return w.t()[:, :, None, None].contiguous(memory_format=cl)

    cw = {"w1": conv_w(fw["w1"]), "w3": conv_w(fw["w3"]),
          "w2": fw["w2"].permute(3, 2, 0, 1).contiguous(memory_format=cl)}
    if "wd" in fw:
        cw["wd"] = conv_w(fw["wd"])
    cb = {k: v.to(torch.bfloat16) for k, v in fw.items() if k[0] == "b"}

    def run(x):
        xc = x.permute(0, 3, 1, 2)           # NCHW view of NHWC data
        h = F.relu(F.conv2d(xc, cw["w1"], cb["b1"]))
        h = F.relu(F.conv2d(h, cw["w2"], cb["b2"], stride=stride, padding=1,
                            groups=32))
        y = F.conv2d(h, cw["w3"], cb["b3"])
        idn = (F.conv2d(xc, cw["wd"], cb["bd"], stride=stride)
               if "wd" in cw else xc)
        return F.relu(y + idn)

    return run


def phase_k1():
    gen = torch.Generator().manual_seed(1)
    max_abs = 0.0
    for name, H, cin, width, cout, s, ds, _ in BLOCKS_EDGE:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, CHECK_BATCH)
        max_abs = max(max_abs, check(
            f"K1 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference(x, fw, stride=s)))

    # the trunk's block shapes at the slice's batch: checked, then timed
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    for name, H, cin, width, cout, s, ds, count in BLOCKS_224:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, BATCH)
        max_abs = max(max_abs, check(
            f"K1 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference(x, fw, stride=s)))
        lib = conv_chain(fw, s)
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference(x, fw, stride=s),
            lambda: lib(x), 20)
        Ho = (H - 1) // s + 1
        flops = 2 * BATCH * (
            H * H * cin * width
            + Ho * Ho * (9 * width // 32 * width + width * cout
                         + (cin * cout if ds else 0)))
        nbytes = (2 * BATCH * (H * H * cin + Ho * Ho * cout)
                  + sum(t.numel() * t.element_size() for t in fw.values()))
        b_ms, b_by = launch_bound(total, flops, nbytes, count)
        log(f"  K1 {name} B={BATCH}: kernel {k:.3f} ms, plain f32 {p:.3f} "
            f"ms, cuDNN bf16 {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {flops / k / 1e9:.1f} TFLOP/s")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            total[key] += count * v
        del x, fw, lib
    log(f"  K1 over the 16 blocks of one forward at B={BATCH}: kernel "
        f"{total['ms']:.3f} ms, plain f32 {total['plain_ms']:.3f} ms, cuDNN "
        f"bf16 {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} "
        f"ms summed per launch ({total['bound_by']}: "
        f"{total['bound_share']})")
    return dict(max_abs_err=max_abs, ms=total["ms"],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by=total["bound_by"], library_ms=total["library_ms"])


# ---------------------------------------------------------------- phase 2b

def vit_half_inputs(gen, kind, B, N, C, F_):
    """bf16 x and the half's operands: LayerNorm scale and bias, then
    (wqkv [C, 3C], bqkv, wproj [C, C], bproj) or (w1 [C, F], b1, w2, b2)."""
    out_a, in_b = (3 * C, C) if kind == "attention" else (F_, F_)
    shapes = [((B, N, C), 1.0), ((C,), 0.1), ((C,), 0.1),
              ((C, out_a), C ** -0.5), ((out_a,), 0.1),
              ((in_b, C), in_b ** -0.5), ((C,), 0.1)]
    x, *params = [(torch.randn(*s, generator=gen) * sc).to("cuda",
                                                           torch.bfloat16)
                  for s, sc in shapes]
    params[0] = params[0] + 1.0
    return x, params


def attention_library(x, params, heads, eps=1e-6):
    """The library call for K5, in bf16: LayerNorm, Linear,
    scaled_dot_product_attention, Linear and the residual."""
    g, b, wqkv, bqkv, wproj, bproj = params
    wq, wp = wqkv.t().contiguous(), wproj.t().contiguous()
    B, N, C = x.shape

    def run():
        xn = F.layer_norm(x, (C,), g, b, eps)
        q, k, v = (F.linear(xn, wq, bqkv).reshape(B, N, 3, heads, C // heads)
                   .permute(2, 0, 3, 1, 4))
        y = F.scaled_dot_product_attention(q, k, v)
        return x + F.linear(y.transpose(1, 2).reshape(B, N, C), wp, bproj)

    return run


def mlp_chain(params, eps=1e-6, gelu="erf"):
    """The library call for K6 as a function of x, in bf16: LayerNorm,
    Linear, GELU (erf; or CLIP's quick_gelu, h * sigmoid(1.702 h), for
    "sigmoid"), Linear and the residual."""
    g, b, w1, b1, w2, b2 = params
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    act = {"erf": F.gelu,
           "sigmoid": lambda h: h * torch.sigmoid(1.702 * h)}[gelu]

    def run(x):
        h = act(F.linear(F.layer_norm(x, (x.shape[-1],), g, b, eps), w1t,
                         b1))
        return x + F.linear(h, w2t, b2)

    return run


def mlp_library(x, params, eps=1e-6, gelu="erf"):
    chain = mlp_chain(params, eps, gelu)
    return lambda: chain(x)


def phase_vit_kernels():
    gen = torch.Generator().manual_seed(2)
    out = {}
    for B, N, C, heads, F_, kv in VIT_CASES:
        scale = (C // heads) ** -0.5
        xa, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
        xm, pm = vit_half_inputs(gen, "mlp", B, N, C, F_)
        runs = {
            "K5": (lambda: fused_block_attention(xa, *pa, heads, scale, kv),
                   lambda: block_attention_reference(xa, *pa, heads, scale,
                                                     kv),
                   attention_library(xa, pa, heads),
                   (2 * B * N * C * 3 * C + 2 * B * N * C * C
                    + 4 * B * N * N * C),
                   2 * (2 * B * N * C) + 2 * 4 * C * C),
            "K6": (lambda: fused_mlp(xm, *pm), lambda: mlp_reference(xm, *pm),
                   mlp_library(xm, pm), 4 * B * N * C * F_,
                   2 * (2 * B * N * C) + 2 * 2 * C * F_)}
        for name, (kernel, plain, library, flops, nbytes) in runs.items():
            what = f"{name} B={B} N={N} C={C}" + (
                f" kv_valid={kv}" if name == "K5" else f" F={F_}")
            with torch.no_grad():
                err = check(what, kernel(), plain())
            res = out.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if B != BATCH:
                continue
            with torch.no_grad():
                k, p, li = time_in_turns(kernel, plain, library, 20)
            b_ms, b_by = bound(flops, nbytes)
            log(f"  {name} B={B} N={N} C={C}: kernel {k:.3f} ms, plain "
                f"{p:.3f} ms, library bf16 {li:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by}); kernel {flops / k / 1e9:.1f} TFLOP/s")
            # per forward: one launch per block
            b_fwd, _ = bound(VIT_DEPTH * flops, VIT_DEPTH * nbytes)
            res.update(ms=VIT_DEPTH * k, plain_ms=VIT_DEPTH * p,
                       library_ms=VIT_DEPTH * li, bound_ms=b_fwd,
                       bound_by=b_by)
    with torch.no_grad():
        for B, N, C, heads, F_, kv in VIT_LONG_CASES:
            scale = (C // heads) ** -0.5
            xa, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
            err = check(f"K5 B={B} N={N} C={C} kv_valid={kv}",
                        fused_block_attention(xa, *pa, heads, scale, kv),
                        block_attention_reference(xa, *pa, heads, scale, kv))
            out["K5"]["max_abs_err"] = max(out["K5"]["max_abs_err"], err)
        for B, N, C, F_ in MLP_RAGGED_CASES:
            xm, pm = vit_half_inputs(gen, "mlp", B, N, C, F_)
            for gelu in GELU_MODES:
                err = check(f"K6 {gelu} B={B} N={N} C={C} F={F_}",
                            fused_mlp(xm, *pm, 1e-6, gelu),
                            mlp_reference(xm, *pm, 1e-6, gelu))
                out["K6"]["max_abs_err"] = max(out["K6"]["max_abs_err"], err)
        mlp_denses(gen)
    for name, res in out.items():
        log(f"  {name} over the {VIT_DEPTH} blocks of one forward at "
            f"B={BATCH}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
            f" ms, library bf16 {res['library_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return out


def mlp_denses(gen):
    """K6's fc1 (bias and the erf GELU) and fc2 (the residual sum) alone on
    its ping-pong tile at the ViT-B shape of the slice, through the
    library's ``mmb_vit_mlp_dense_bf16`` (not counted as wrapper
    launches): each checked against its f32 product, then timed."""
    lib = _build.library()
    M, C, F_ = BATCH * 257, 768, 3072
    geo = mlp_geometry(
        M, C, F_, torch.cuda.get_device_properties(0).multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream
    for name, K, N, epi, d in (("fc1", C, F_, 2, geo.fc1),
                               ("fc2", F_, C, 1, geo.fc2)):
        a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(K, N, generator=gen) * K ** -0.5).to(
            "cuda", torch.bfloat16)
        bias = (torch.randn(N, generator=gen) * 0.1).to("cuda",
                                                        torch.bfloat16)
        res = torch.randn(M, N, generator=gen).to("cuda", torch.bfloat16)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")

        def run():
            _build.check(lib, lib.mmb_vit_mlp_dense_bf16(
                a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                res.data_ptr() if epi == 1 else 0, out.data_ptr(), M, K, N,
                epi, 0, d.grid, stream), name)

        run()
        exact = a.float() @ w.float()
        want = (F.gelu(exact + bias.float()) if epi == 2
                else res.float() + exact + bias.float())
        check(f"K6 {name} alone [{M}x{K}].[{K}x{N}]", out, want)
        ms = time_ms(run, 20)
        log(f"  K6 {name} alone: {ms:.4f} ms, "
            f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s ({d.grid} blocks, "
            f"{d.tiles} tiles)")


# ---------------------------------------------------------------- phase 2d

def sdpa_token_major(q, k, v, heads):
    """scaled_dot_product_attention on [B, N, C] views, heads (head, d)."""
    B, N, C = q.shape

    def split(t):
        return t.reshape(B, N, heads, C // heads).transpose(1, 2)

    y = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return y.transpose(1, 2).reshape(B, N, C)


def phase_vit_more_kernels():
    gen = torch.Generator().manual_seed(4)
    out = {k: {"max_abs_err": 0.0} for k in ("K7", "K8a", "K8b", "K8c")}
    for B, N, C, heads, F_, kv in VIT_CASES:
        scale = (C // heads) ** -0.5
        x, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
        _, pm = vit_half_inputs(gen, "mlp", 1, 1, C, F_)
        blk = pa + pm
        qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                         torch.bfloat16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

        def heads_first(t):
            return (t.reshape(B, N, heads, C // heads).transpose(1, 2)
                    .reshape(B * heads, N, C // heads))

        qh, kh, vh = map(heads_first, (q, k, v))
        tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")

        def note(name, err):
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

        with torch.no_grad():
            for gelu in GELU_MODES:
                if gelu != "erf":  # 2b checks the erf form
                    check(f"K6 {gelu} {tag}", fused_mlp(x, *pm, 1e-6, gelu),
                          mlp_reference(x, *pm, 1e-6, gelu))
                k7 = fused_vit_block(x, *blk, heads, scale, kv, 1e-6, gelu)
                note("K7", check(f"K7 {gelu} {tag}", k7, vit_block_reference(
                    x, *blk, heads, scale, kv, 1e-6, gelu)))
                two = fused_mlp(fused_block_attention(x, *pa, heads, scale,
                                                      kv), *pm, 1e-6, gelu)
                n_diff = int((k7.view(torch.int16)
                              != two.view(torch.int16)).sum())
                log(f"  K7 {gelu} {tag}: {n_diff} of {k7.numel()} bf16 words "
                    f"differ from K5 then K6")
                if n_diff:
                    raise AssertionError(f"K7 {gelu} {tag}: {n_diff} words "
                                         f"differ from K5 then K6")
            note("K8a", check(f"K8a {tag}", fused_attention(qh, kh, vh, scale,
                                                            kv),
                              attention_reference(qh, kh, vh, scale, kv)))
            note("K8b", check(f"K8b {tag}",
                              fused_attention_pairs(q, k, v, heads, scale, kv),
                              attention_pairs_reference(q, k, v, heads, scale,
                                                        kv)))
            note("K8c", check(f"K8c {tag}", fused_qkv_attention_pairs(
                x, pa[2], pa[3], heads, scale, kv),
                qkv_attention_pairs_reference(x, pa[2], pa[3], heads, scale,
                                              kv)))
        if B != BATCH:
            continue
        wqkv_t = pa[2].t().contiguous()
        block_chain = (attention_library(x, pa, heads), mlp_chain(pm))
        act = 2 * B * N * C  # bytes of one [B, N, C] bf16 tensor
        attn_flops = 4 * B * N * N * C
        runs = {
            "K7": (lambda: fused_vit_block(x, *blk, heads, scale),
                   lambda: vit_block_reference(x, *blk, heads, scale),
                   lambda: block_chain[1](block_chain[0]()),
                   (2 * B * N * C * 3 * C + 2 * B * N * C * C + attn_flops
                    + 4 * B * N * C * F_),
                   2 * act + 2 * (4 * C * C + 2 * C * F_)),
            "K8a": (lambda: fused_attention(qh, kh, vh, scale),
                    lambda: attention_reference(qh, kh, vh, scale),
                    lambda: F.scaled_dot_product_attention(
                        qh[None], kh[None], vh[None])[0],
                    attn_flops, 4 * act),
            "K8b": (lambda: fused_attention_pairs(q, k, v, heads, scale),
                    lambda: attention_pairs_reference(q, k, v, heads, scale),
                    lambda: sdpa_token_major(q, k, v, heads),
                    attn_flops, 4 * act),
            "K8c": (lambda: fused_qkv_attention_pairs(x, pa[2], pa[3], heads,
                                                      scale),
                    lambda: qkv_attention_pairs_reference(x, pa[2], pa[3],
                                                          heads, scale),
                    lambda: sdpa_token_major(
                        *F.linear(x, wqkv_t, pa[3]).split(C, -1), heads),
                    2 * B * N * C * 3 * C + attn_flops,
                    2 * act + 2 * (3 * C * C + 3 * C))}
        with torch.no_grad():
            for name, (kernel, plain, library, flops, nbytes) in runs.items():
                kms, pms, lms = time_in_turns(kernel, plain, library, 20)
                b_ms, b_by = bound(flops, nbytes)
                log(f"  {name} B={B} N={N} C={C}: kernel {kms:.3f} ms, plain "
                    f"{pms:.3f} ms, library bf16 {lms:.3f} ms, bound "
                    f"{b_ms:.3f} ms ({b_by}); kernel "
                    f"{flops / kms / 1e9:.1f} TFLOP/s")
                b_fwd, _ = bound(VIT_DEPTH * flops, VIT_DEPTH * nbytes)
                out[name].update(ms=VIT_DEPTH * kms, plain_ms=VIT_DEPTH * pms,
                                 library_ms=VIT_DEPTH * lms, bound_ms=b_fwd,
                                 bound_by=b_by)
            two_ms = time_ms(lambda: fused_mlp(fused_block_attention(
                x, *pa, heads, scale), *pm), 20)
        log(f"  K7 against the port's own K5 then K6 at B={B}: "
            f"{out['K7']['ms'] / VIT_DEPTH:.3f} against {two_ms:.3f} ms per "
            f"block")
    with torch.no_grad():
        for B, N, C, heads, F_, kv in VIT_LONG_CASES:
            scale = (C // heads) ** -0.5
            x, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
            _, pm = vit_half_inputs(gen, "mlp", 1, 1, C, F_)
            tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")
            for gelu in GELU_MODES:
                k7 = fused_vit_block(x, *pa, *pm, heads, scale, kv, 1e-6,
                                     gelu)
                out["K7"]["max_abs_err"] = max(
                    out["K7"]["max_abs_err"],
                    check(f"K7 {gelu} {tag}", k7, vit_block_reference(
                        x, *pa, *pm, heads, scale, kv, 1e-6, gelu)))
                two = fused_mlp(fused_block_attention(x, *pa, heads, scale,
                                                      kv), *pm, 1e-6, gelu)
                n_diff = int((k7.view(torch.int16)
                              != two.view(torch.int16)).sum())
                log(f"  K7 {gelu} {tag}: {n_diff} of {k7.numel()} bf16 words "
                    f"differ from K5 then K6")
                if n_diff:
                    raise AssertionError(f"K7 {gelu} {tag}: {n_diff} words "
                                         f"differ from K5 then K6")
        for B, N, C, heads, kv in K8_EDGE_CASES:
            scale = (C // heads) ** -0.5
            tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")
            qh, kh, vh = (torch.randn(B * heads, N, C // heads, generator=gen)
                          .to("cuda", torch.bfloat16) for _ in range(3))
            out["K8a"]["max_abs_err"] = max(
                out["K8a"]["max_abs_err"],
                check(f"K8a {tag}", fused_attention(qh, kh, vh, scale, kv),
                      attention_reference(qh, kh, vh, scale, kv)))
            qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                             torch.bfloat16)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            out["K8b"]["max_abs_err"] = max(
                out["K8b"]["max_abs_err"],
                check(f"K8b {tag}",
                      fused_attention_pairs(q, k, v, heads, scale, kv),
                      attention_pairs_reference(q, k, v, heads, scale, kv)))
            if N > MAX_TOKENS_QKV:
                continue
            x, pa = vit_half_inputs(gen, "attention", B, N, C, 4 * C)
            out["K8c"]["max_abs_err"] = max(
                out["K8c"]["max_abs_err"],
                check(f"K8c {tag}", fused_qkv_attention_pairs(
                    x, pa[2], pa[3], heads, scale, kv),
                    qkv_attention_pairs_reference(x, pa[2], pa[3], heads,
                                                  scale, kv)))
    for name, res in out.items():
        log(f"  {name} over the {VIT_DEPTH} blocks of one forward at "
            f"B={BATCH}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
            f" ms, library bf16 {res['library_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return out


# ---------------------------------------------------------------- phase 2e

PEAK_FLOPS_F32 = 67e12  # H100 SXM f32 outside the tensor cores, at 700 W
PEAK_FLOPS_TF32 = 495e12  # H100 SXM dense TF32 tensor cores, at 700 W
LSTM_H = 512            # CVCL's hidden width (= the embedding width)
LM_LEN = 64             # the JAX package's length rule: K9 from 64 steps
INFONCE_E = 512
INFONCE_BATCHES = (BATCH, 1024)  # the slice's batch; MAX_FUSED_BATCH


def profiled_ms(fn, calls: int = 20):
    """(device ms a call, {kernel name: device ms a call}): the profiler's
    device events (kernels, fills, copies; not an autograd Function's
    annotation) over ``calls`` calls (after one call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for e in prof.events():  # the device's own events: kernels, fills, copies
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kernels[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    return sum(kernels.values()), kernels


def timed(what, kernel, plain, library, iters):
    """time_in_turns, each time printed beside the profiler's device time;
    returns the event times (kernel, plain, library)."""
    times = time_in_turns(kernel, plain, library, iters)
    dev = [profiled_ms(fn)[0] for fn in (kernel, plain, library)]
    log(f"  {what}: event / profiler device ms a call: kernel "
        f"{times[0]:.4f} / {dev[0]:.4f}, plain {times[1]:.4f} / "
        f"{dev[1]:.4f}, library {times[2]:.4f} / {dev[2]:.4f}")
    return times


def lstm_case(gen, B, L, H):
    """K9's inputs at (B, L, H) with the lengths make_batch gives (1 to L),
    the time-major input projection of N(0, 1) embeddings; cuDNN's nn.LSTM
    with the same weights over the packed embeddings (the library call,
    which also does the input projection) and that projection alone (one
    GEMM over the packed tokens, as nn.LSTM runs it)."""
    k = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * k

    lens = torch.randint(1, L + 1, (B,), generator=gen)
    lens[0] = L
    w_ih, w_hh, b_ih, b_hh = u(4 * H, H), u(4 * H, H), u(4 * H), u(4 * H)
    emb = torch.randn(B, L, H, generator=gen)
    h0, c0 = 0.1 * torch.randn(B, H, generator=gen), torch.zeros(B, H)
    lib = torch.nn.LSTM(H, H, batch_first=True)
    with torch.no_grad():
        for name, w in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                        ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(lib, name).copy_(w)
    lib = lib.cuda()
    emb, h0, c0 = emb.cuda(), h0.cuda(), c0.cuda()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        emb, lens, batch_first=True, enforce_sorted=False)
    x_proj = (emb @ w_ih.cuda().T + (b_ih + b_hh).cuda()).transpose(0, 1)
    mask = (torch.arange(L)[:, None] < lens[None, :]).float().cuda()
    args = (x_proj.contiguous(), mask, w_hh.T.contiguous().cuda(), h0, c0)
    w_t, bias = w_ih.T.contiguous().cuda(), (b_ih + b_hh).cuda()
    return (args, (lambda: lib(packed, (h0[None], c0[None]))), lens,
            (lambda: torch.addmm(bias, packed.data, w_t)))


def lstm_cost(L, B, H, lens):
    """(flops, bytes) K9 needs: the h W_hh products of the valid steps (the
    gates' few operations per unit are left out), each input read once and
    each output written once, in f32."""
    flops = 2 * int(lens.sum()) * H * 4 * H
    nbytes = 4 * (L * B * 4 * H + L * B + H * 4 * H + 2 * B * H
                  + L * B * H + 2 * B * H)
    return flops, nbytes


def bounds(what, flops, nbytes, kms):
    """The f32-rate bound (the row's) and, beside it, the bound of the
    same work as three TF32 tensor-core products, which the kernels run."""
    b_ms, b_by = bound(flops, nbytes, PEAK_FLOPS_F32)
    t_ms, t_by = bound(3 * flops, nbytes, PEAK_FLOPS_TF32)
    log(f"  {what}: bound {b_ms:.4f} ms ({b_by}, f32 at 67 TFLOP/s); "
        f"3xTF32 tensor-core bound {t_ms:.4f} ms ({t_by}, 3 x {flops / 1e6:.1f}"
        f" MFLOP at 495 TFLOP/s); kernel {flops / kms / 1e9:.2f} f32-"
        f"equivalent TFLOP/s")
    return b_ms, b_by


def phase_lstm_kernel():
    gen = torch.Generator().manual_seed(7)
    res = {"max_abs_err": 0.0}
    for L in (MAX_LEN_UTTERANCE, LM_LEN):
        args, library, lens, gemm = lstm_case(gen, BATCH, L, LSTM_H)
        with torch.no_grad():
            got = lstm_fused(*args)
            want = scan_reference(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("out", "h_last", "c_last"), got, want):
                err = float((g - w).abs().max())
                log(f"  K9 B={BATCH} L={L} H={LSTM_H} {name} "
                    f"{tuple(g.shape)}: max_abs_err {err:.3g}")
                if not err <= 1e-4:
                    raise AssertionError(f"K9 L={L} {name}: max abs err "
                                         f"{err:.3g} > 1e-4")
                res["max_abs_err"] = max(res["max_abs_err"], err)
            again = lstm_fused(*args)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"K9 L={L}: a repeated call gave other "
                                     f"bits")
            out_lib, _ = library()
            unpacked, _ = torch.nn.utils.rnn.pad_packed_sequence(
                out_lib, batch_first=True, total_length=L)
            lib_err = float((unpacked.transpose(0, 1) - want[0]).abs().max())
            log(f"  cuDNN nn.LSTM against the plain scan: max abs err "
                f"{lib_err:.3g}")
            what = f"K9 B={BATCH} L={L} H={LSTM_H} ({int(lens.sum())} valid " \
                f"steps)"
            kms, pms, lms = timed(what, lambda: lstm_fused(*args),
                                  lambda: scan_reference(*args), library, 20)
            gms = time_ms(gemm, 20)
            gdev = profiled_ms(gemm)[0]
        log(f"  {what}: nn.LSTM's input projection alone (addmm over the "
            f"packed tokens) {gms:.4f} ms (device {gdev:.4f}); nn.LSTM "
            f"without it {lms - gms:.4f} ms (the row's library time)")
        flops, nbytes = lstm_cost(L, BATCH, LSTM_H, lens)
        b_ms, b_by = bounds(what, flops, nbytes, kms)
        if L == MAX_LEN_UTTERANCE:  # the slice's window
            res.update(ms=kms, plain_ms=pms, library_ms=lms - gms,
                       bound_ms=b_ms, bound_by=b_by)
    return res


def infonce_library(img, txt, nlt):
    """torch.matmul and two F.cross_entropy calls: (forward, backward by
    autograd on a graph built once)."""
    labels = torch.arange(img.shape[0], device=img.device)

    def loss_of(i, t, n):
        logits = n.exp() * (i @ t.T)
        return (F.cross_entropy(logits, labels)
                + F.cross_entropy(logits.T, labels)) / 2

    leaves = [x.clone().requires_grad_() for x in (img, txt, nlt)]
    loss = loss_of(*leaves)
    return (lambda: loss_of(img, txt, nlt),
            lambda: torch.autograd.grad(loss, leaves, retain_graph=True))


def phase_infonce_kernels():
    gen = torch.Generator().manual_seed(8)
    nlt = torch.tensor(math.log(1 / 0.07), device="cuda")
    out = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    for B in INFONCE_BATCHES:
        E = INFONCE_E
        x = torch.randn(2, B, E, generator=gen)
        img, txt = (l2_normalize(x, dim=-1)).cuda().unbind(0)
        g = torch.tensor(1.0, device="cuda")
        loss, lse_i, lse_t, metrics = fused_infonce_forward(img, txt, nlt)
        leaves = [t.clone().requires_grad_() for t in (img, txt, nlt)]
        loss_w, lse_i_w, lse_t_w, m_w = infonce_reference(*leaves)
        grads_w = torch.autograd.grad(loss_w, leaves)
        grads = fused_infonce_backward(img, txt, nlt, lse_i, lse_t, g)
        torch.cuda.synchronize()
        loss_w, lse_i_w, lse_t_w = (t.detach()
                                    for t in (loss_w, lse_i_w, lse_t_w))
        rel = abs(float(loss) - float(loss_w)) / abs(float(loss_w))
        lse_err = max(float((lse_i - lse_i_w).abs().max()),
                      float((lse_t - lse_t_w).abs().max()))
        acc_same = torch.equal(metrics[:2], m_w[:2])
        ent_rel = float(((metrics[2:] - m_w[2:]).abs() / m_w[2:].abs()).max())
        log(f"  K4 forward B={B} E={E}: loss {float(loss):.6f} rel err "
            f"{rel:.3g}, lse max abs err {lse_err:.3g}, accuracies "
            f"{metrics[:2].tolist()} (plain {m_w[:2].tolist()}), entropies "
            f"rel err {ent_rel:.3g}")
        if not (rel <= 1e-5 and lse_err <= 1e-5 and acc_same
                and ent_rel <= 1e-4):
            raise AssertionError(f"K4 forward B={B} against its plain version")
        bwd_err = 0.0
        for name, a, w in zip(("d_img", "d_txt", "d_neg_log_temp"), grads,
                              grads_w):
            err = float((a - w).abs().max())
            bwd_err = max(bwd_err, err)
            log(f"  K4 backward B={B} {name} {tuple(a.shape)}: max abs err "
                f"{err:.3g}")
            if not torch.allclose(a, w, atol=1e-4, rtol=1e-3):
                raise AssertionError(f"K4 backward B={B} {name}: outside "
                                     f"atol 1e-4, rtol 1e-3")
        again = fused_infonce_forward(img, txt, nlt)
        if not all(torch.equal(a, b) for a, b in
                   zip(again, (loss, lse_i, lse_t, metrics))):
            raise AssertionError(f"K4 forward B={B}: a repeated call gave "
                                 f"other bits")
        again = fused_infonce_backward(img, txt, nlt, lse_i, lse_t, g)
        if not all(torch.equal(a, b) for a, b in zip(again, grads)):
            raise AssertionError(f"K4 backward B={B}: a repeated call gave "
                                 f"other bits")
        out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"],
                                        abs(float(loss) - float(loss_w)),
                                        lse_err)
        out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], bwd_err)

        lib_fwd, lib_bwd = infonce_library(img, txt, nlt)
        with torch.no_grad():
            fwd = timed(
                f"K4 fwd B={B} E={E}",
                lambda: fused_infonce_forward(img, txt, nlt),
                lambda: infonce_reference(img, txt, nlt), lib_fwd, 20)
            bwd = timed(
                f"K4 bwd B={B} E={E}",
                lambda: fused_infonce_backward(img, txt, nlt, lse_i, lse_t,
                                               g),
                lambda: infonce_backward_reference(img, txt, nlt, lse_i,
                                                   lse_t, g), lib_bwd, 20)
        act = 4 * 2 * B * E  # bytes of img and txt in f32
        costs = {"fwd": (2 * B * B * E, act + 4 * (2 * B + 5)),
                 "bwd": (6 * B * B * E, 2 * act + 4 * (2 * B + 3))}
        for (key, (flops, nbytes)), (kms, pms, lms) in zip(costs.items(),
                                                           (fwd, bwd)):
            log(f"  K4 {key} B={B} E={E}: kernel {kms:.4f} ms, plain "
                f"{pms:.4f} ms, library {lms:.4f} ms")
            b_ms, b_by = bounds(f"K4 {key} B={B} E={E}", flops, nbytes, kms)
            if B == BATCH:  # the slice's batch
                out[key].update(ms=kms, plain_ms=pms, library_ms=lms,
                                bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------- phase 2c

# the int8 blocks of layers 3-4 at 224 px: (name, H, Cin, width, Cout,
# stride, downsample)
Q_BLOCKS_224 = [
    ("layer3.0", 28, 512, 512, 1024, 2, True),
    ("layer3.1", 14, 1024, 512, 1024, 1, False),
    ("layer4.0", 14, 1024, 1024, 2048, 2, True),
    ("layer4.1", 7, 2048, 1024, 2048, 1, False),
]
# (name, H, Cin, width, Cout, stride, downsample, batch): B = 2 gives row
# counts the int8 tile's 128- and 64-row tiles do not divide
Q_BLOCKS_EDGE = [
    ("8x8 stride 1", 8, 256, 128, 256, 1, False, Q_CHECK_BATCH),
    ("8x8 stride 2", 8, 256, 128, 256, 2, True, Q_CHECK_BATCH),
    ("odd 7->4 stride 2", 7, 512, 512, 1024, 2, True, Q_CHECK_BATCH),
    ("8x8 Cin 64", 8, 64, 128, 256, 1, True, Q_CHECK_BATCH),
    ("ragged 9->5 stride 2", 9, 512, 512, 1024, 2, True, 2),
    ("ragged 7x7", 7, 1024, 512, 1024, 1, False, 2),
]
# stages: (name, H, Cin, width, Cout, strides, int8, band); band None = K3a
STAGES_224 = [
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, True, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], True, None),
    ("layer1", 56, 64, 128, 256, [1, 1, 1], False, 28),
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, False, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], False, None),
]
# (name, H, Cin, width, Cout, strides, int8, band[, batch: Q_CHECK_BATCH])
STAGES_EDGE = [
    ("8x8 stride-2 head", 8, 256, 128, 256, [2, 1, 1], True, None),
    ("ragged 9->5 stride-2 head", 9, 512, 512, 1024, [2, 1], True, None, 2),
    ("odd 7->4 stride-2 head", 7, 512, 512, 1024, [2, 1], True, None),
    ("16x16, 4 bands", 16, 64, 128, 256, [1, 1, 1], False, 4),
    ("16x16 stride-2 head, 4 bands", 16, 128, 128, 256, [2, 1, 1], False, 4),
    ("16x16, 2 bands", 16, 64, 128, 256, [1, 1, 1], True, 8),
]


def random_block_state(gen, cin, width, cout, has_ds):
    """A BottleneckX state dict (torch names): He-normal convolutions, BN
    scale 1 + 0.1 N(0, 1), bias and mean 0.1 N(0, 1), var U(0.5, 2)."""
    sd = {}
    convs = [("conv1", width, cin, 1), ("conv2", width, width // 32, 3),
             ("conv3", cout, width, 1)]
    bns = [("bn1", width), ("bn2", width), ("bn3", cout)]
    if has_ds:
        convs.append(("downsample.0", cout, cin, 1))
        bns.append(("downsample.1", cout))
    for name, o, i, k in convs:
        sd[f"{name}.weight"] = (torch.randn(o, i, k, k, generator=gen)
                                * math.sqrt(2.0 / (i * k * k)))
    for name, c in bns:
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)
    return sd


def random_q_block(gen, cin, width, cout, has_ds):
    """int8 folded weights of one block on the card (amax as
    tests/test_quant_trunk.py: in 2.0, h1 and h2 1.5, out 2.5)."""
    fw = fold_block_params_q(random_block_state(gen, cin, width, cout,
                                                has_ds), 2.0, 1.5, 1.5, 2.5)
    return {k: v.cuda() for k, v in fw.items()}


def random_codes(gen, batch, H, cin):
    return torch.randint(0, 100, (batch, H, H, cin), generator=gen,
                         dtype=torch.int8).cuda()


def check_codes(what, got, want) -> float:
    """An int8 kernel's codes against its plain version's."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.int8:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} int8")
    diff = (got.int() - want.int()).abs()
    n_diff = int((diff > 0).sum())
    frac = n_diff / diff.numel()
    log(f"  {what:34s} out {tuple(got.shape)}: {n_diff} of {diff.numel()} "
        f"codes differ (max {int(diff.max())}); nonzero "
        f"{float((want > 0).float().mean()):.3f}")
    if int(diff.max()) > 1 or frac >= 1e-3:
        raise AssertionError(f"{what}: {n_diff} codes differ, max "
                             f"{int(diff.max())}")
    return float(diff.max())


def int8_chain(fw, stride):
    """The library chain for K2: torch._int_mm for the 1x1 GEMMs, the cuDNN
    grouped 3x3 on the codes in bf16 (channels-last), torch elementwise
    requantization."""
    width = fw["w1"].shape[0]
    w2 = fw["w2"].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    # torch._int_mm takes B as [K, N]; the fold's 1x1 weights are [N, K]
    wt = {k: fw[k].t().contiguous() for k in ("w1", "w3", "wd") if k in fw}

    def rq(acc, a, b):
        return torch.round(acc.float() * a + b).clamp_(0, 127).to(torch.int8)

    def run(x):
        B, H, W, cin = x.shape
        h1 = rq(torch._int_mm(x.reshape(-1, cin), wt["w1"]), fw["a1"],
                fw["b1"]).reshape(B, H, W, width)
        acc2 = F.conv2d(h1.permute(0, 3, 1, 2).to(torch.bfloat16), w2,
                        stride=stride, padding=1, groups=32)
        h2 = rq(acc2.permute(0, 2, 3, 1).reshape(-1, width), fw["a2"],
                fw["b2"])
        y = torch._int_mm(h2, wt["w3"]).float() * fw["a3"] + fw["b3"]
        if "wd" in fw:
            xs = x[:, ::stride, ::stride].reshape(-1, cin)
            ident = (torch._int_mm(xs, wt["wd"]).float() * fw["ad"]
                     + fw["bd"])
        else:
            ident = x.reshape(-1, cin).float() * fw["ai"]
        Ho = acc2.shape[2]
        return torch.round(y + ident).clamp_(0, 127).to(torch.int8).reshape(
            B, Ho, -1, fw["w3"].shape[0])

    return run


def block_cost(H, cin, width, cout, stride, has_ds, batch):
    """(operations, activation bytes per element size) of one block."""
    Ho = (H - 1) // stride + 1
    ops = 2 * batch * (H * H * cin * width
                       + Ho * Ho * (9 * width // 32 * width + width * cout
                                    + (cin * cout if has_ds else 0)))
    return ops, batch * (H * H * cin + Ho * Ho * cout)


def weight_bytes(fws):
    return sum(t.numel() * t.element_size() for fw in fws
               for t in fw.values())


def stage_inputs(gen, H, cin, width, cout, strides, int8, batch):
    """A stage's input and folded blocks on the card; the head has a
    downsample where it changes the shape."""
    fws = []
    for j, s in enumerate(strides):
        c = cin if j == 0 else cout
        ds = j == 0 and (c != cout or s != 1)
        fws.append(random_q_block(gen, c, width, cout, ds) if int8 else
                   random_block(gen, H, c, width, cout, s, ds, 1)[1])
    if int8:
        return random_codes(gen, batch, H, cin), fws
    x = torch.randn(batch, H, H, cin, generator=gen).clamp_min(0.0)
    return x.to("cuda", torch.bfloat16), fws


def stage_cost(H, cin, width, cout, strides, fws, batch):
    """(operations, bytes): every block's operations without halo
    recompute; one read of the input, one write of the output, the
    weights."""
    ops, h, c = 0, H, cin
    for fw, s in zip(fws, strides):
        ops += block_cost(h, c, width, cout, s, "wd" in fw, batch)[0]
        h, c = (h - 1) // s + 1, cout
    esize = 1 if fws[0]["w1"].dtype == torch.int8 else 2
    nbytes = (esize * batch * (H * H * cin + h * h * cout)
              + weight_bytes(fws))
    return ops, nbytes


def phase_int8_and_stages():
    gen = torch.Generator().manual_seed(3)
    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
           for k in ("K2", "K3a", "K3b")}
    for name, H, cin, width, cout, s, ds, batch in Q_BLOCKS_EDGE:
        fw = random_q_block(gen, cin, width, cout, ds)
        x = random_codes(gen, batch, H, cin)
        res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], check_codes(
            f"K2 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_q(x, fw, stride=s)))
    for name, H, cin, width, cout, s, ds in Q_BLOCKS_224:
        fw = random_q_block(gen, cin, width, cout, ds)
        x = random_codes(gen, BATCH, H, cin)
        res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], check_codes(
            f"K2 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_q(x, fw, stride=s)))
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference_q(x, fw, stride=s),
            lambda: int8_chain(fw, s)(x), 20)
        ops, act = block_cost(H, cin, width, cout, s, ds, BATCH)
        b_ms, b_by = bound(ops, act + weight_bytes([fw]), PEAK_OPS_INT8)
        log(f"  K2 {name} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library int8 chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TOP/s")
        if name == "layer3.0":  # the one K2 launch of the published plan
            res["K2"].update(ms=k, plain_ms=p, library_ms=li)
            launch_bound(res["K2"], ops, act + weight_bytes([fw]), 1,
                         PEAK_OPS_INT8)
        del x, fw

    def run_stage(what, H, cin, width, cout, strides, int8, band, batch):
        x, fws = stage_inputs(gen, H, cin, width, cout, strides, int8, batch)
        row = "K3a" if band is None else "K3b"

        def kernel():
            return (fused_stage(x, fws, strides) if band is None
                    else fused_stage_banded(x, fws, strides, band))

        def plain():
            return stage_reference(x, fws, strides)

        desc = (f"{row} {'int8' if int8 else 'bf16'} {what}"
                + (f" N={band}" if band else ""))
        got = kernel()
        err = (check_codes if int8 else check)(desc, got, plain())
        res[row]["max_abs_err"] = max(res[row]["max_abs_err"], err)
        # each body runs its blocks' tiles and grouped 3x3: K1's or K2's
        chain = x
        for fw, s in zip(fws, strides):
            chain = fused_bottleneck(chain, fw, stride=s)
        words = int((got != chain).sum())
        unit, k = ("codes", "K2") if int8 else ("words", "K1")
        log(f"  {desc}: {words} of {got.numel()} {unit} differ from its "
            f"blocks' {k} launches (0 expected)")
        if words:
            raise AssertionError(f"{desc}: {words} {unit} from {k}'s chain")
        return x, fws, kernel, plain, desc

    for name, *case in STAGES_EDGE:
        run_stage(name, *case[:7], *case[7:] or [Q_CHECK_BATCH])
    for name, H, cin, width, cout, strides, int8, band in STAGES_224:
        x, fws, kernel, plain, desc = run_stage(
            name, H, cin, width, cout, strides, int8, band, BATCH)
        chains = [int8_chain(fw, st) if int8 else conv_chain(fw, st)
                  for fw, st in zip(fws, strides)]

        def library():
            y = x
            for chain in chains:  # conv_chain gives an NCHW view: back
                y = chain(y) if int8 else chain(y).permute(0, 2, 3, 1)
            return y

        k, p, li = time_in_turns(kernel, plain, library, 10)
        ops, nbytes = stage_cost(H, cin, width, cout, strides, fws, BATCH)
        peak = PEAK_OPS_INT8 if int8 else PEAK_FLOPS
        b_ms, b_by = bound(ops, nbytes, peak)
        log(f"  {desc} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} T(FL)OP/s")
        row = "K3a" if band is None else "K3b"
        if int8 or band is not None:  # the published plan's launches
            r = res[row]
            for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
                r[key] += v
            launch_bound(r, ops, nbytes, 1, peak)
        del x, fws, chains
    for name, r in res.items():
        log(f"  {name} per B={BATCH} forward of the published plan: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"summed per launch ({r['bound_by']})")
    return res


# ------------------------------------------------------------ phases 3 and 4

def make_batch(rng, b):
    """Synthetic uint8 frames and token ids, as bench.py makes them."""
    images = rng.randint(0, 256, (b, 224, 224, 3), np.uint8)
    text = np.zeros((b, MAX_LEN_UTTERANCE), np.int64)
    lens = rng.randint(1, MAX_LEN_UTTERANCE - 1, b)
    text[:, 0] = 2
    for i, n in enumerate(lens):
        text[i, 1:1 + n] = rng.randint(4, VOCAB, n)
        text[i, 1 + n] = 3
    return {"image_u8": torch.from_numpy(images).cuda(),
            "text": torch.from_numpy(text).cuda(),
            "text_len": torch.from_numpy(lens + 2).cuda()}


def flagship_cfg(vit: bool, trunk_int8=False) -> ExperimentConfig:
    """bench.py's flagship (build_flagship, with ``trunk_int8``) or ViT
    flagship (build_vit_flagship), with the augment on."""
    if vit:
        vision = VisionConfig(vit_dino=True)
        text = TextConfig(text_encoder="transformer",
                          pos_embed_type="learned")
    else:
        vision = VisionConfig(cnn_dino=True, frozen_bn="running",
                              trunk_int8=trunk_int8)
        text = TextConfig(text_encoder="embedding")
    return ExperimentConfig(
        model=ModelConfig(
            embedding_dim=512, vocab_size=VOCAB, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=vision, text=text),
        data=DataConfig(augment_frames=True),
        train=TrainConfig(optimizer="AdamW", lr=1e-4, weight_decay=0.1))


def build_vit_slice():
    """(cfg, model, batch) of the ViT slice with its seeded weights."""
    cfg = flagship_cfg(vit=True)
    gen = torch.Generator().manual_seed(0)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device="cuda",
                 generator=gen)
    with torch.no_grad():  # LayerNorm affine and Dense biases that matter
        for m in model.vision_encoder.model.blocks.modules():
            if isinstance(m, LayerNorm):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
            elif isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.02 * torch.randn(m.bias.numel(),
                                                generator=gen))
    return cfg, model, make_batch(np.random.RandomState(0), BATCH)


def drive(model, cfg, batch, launch_counters, show=()):
    """TRAIN_STEPS train steps then one eval step, the kernel launch counts
    (``(wrapper, attribute)`` pairs) set to 0 just before and read just
    after; the train steps' metrics named in ``show`` are printed. Returns
    (state, train_step, launches per counter)."""
    state = init_train_state(model, cfg)
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    torch.cuda.synchronize()
    for fn, attr in launch_counters:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    metrics = [train_step(state, batch) for _ in range(TRAIN_STEPS)]
    eval_loss = float(eval_step(batch)["loss"])
    torch.cuda.synchronize()
    launches = [getattr(fn, attr) for fn, attr in launch_counters]
    losses = [float(m["loss"]) for m in metrics]
    for k in show:
        log(f"  {k} {[round(float(m[k]), 6) for m in metrics]}")
    log(f"  losses {losses}, eval loss {eval_loss:.5f} "
        f"({time.perf_counter() - t0:.2f} s for the first {TRAIN_STEPS} "
        f"steps + eval, weight preparation included)")
    if not all(math.isfinite(v) for v in losses + [eval_loss]):
        raise AssertionError(f"non-finite loss: {losses}, eval {eval_loss}")
    return state, train_step, launches


def check_frozen_and_heads(model, frozen, heads):
    """The trunk tensors in ``frozen`` are bit-unchanged, the parameters
    in ``heads`` changed."""
    trunk = model.vision_encoder.model
    for k, v in trunk.state_dict().items():
        if k in frozen and not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen trunk tensor {k} changed")
    named = dict(model.named_parameters())
    for k, v in heads.items():
        if torch.equal(named[k].detach(), v):
            raise AssertionError(f"{k} did not change")
    log(f"  trunk unchanged ({len(frozen)} tensors), {len(heads)} head and "
        f"text tensors updated")


def compare_features(what, kernel, plain, f32):
    """Per-row cosines of the kernel path against the plain bf16 path
    (gated) and against f32 (printed)."""
    cp, cf, cpf = (row_cosines(kernel, plain), row_cosines(kernel, f32),
                   row_cosines(plain, f32))
    log(f"  eval {what}: kernel vs plain bf16 cos min "
        f"{float(cp.min()):.7f} mean {float(cp.mean()):.7f}; kernel vs f32 "
        f"min {float(cf.min()):.7f}; plain bf16 vs f32 min "
        f"{float(cpf.min()):.7f}")
    if not (torch.isfinite(kernel).all()
            and float(cp.min()) >= SLICE_COS_TOL):
        raise AssertionError(f"eval {what}: cosine {float(cp.min()):.7f} < "
                             f"{SLICE_COS_TOL}")


def time_steps(state, train_step, batch, what):
    train_step(state, batch)  # untimed: e.g. a refold after a plan change
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    log(f"  {what} train step B={BATCH}: {step_s * 1e3:.3f} ms, "
        f"{BATCH / step_s:.1f} pairs/s")
    return step_s


def build_resnext_slice(trunk_int8, fused_plan, cfg=None):
    """(cfg, model, batch) of the ResNeXt flagship (or of ``cfg``) with
    seeded weights and non-trivial BN statistics (so the fold matters)."""
    cfg = cfg or flagship_cfg(vit=False, trunk_int8=trunk_int8)
    gen = torch.Generator().manual_seed(0)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device="cuda",
                 generator=gen, kernels=KernelConfig(
                     trunk_plan=fused_plan or DEFAULT_PLAN))
    with torch.no_grad():
        for m in model.vision_encoder.model.modules():
            if isinstance(m, InferenceBN):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
    return cfg, model, make_batch(np.random.RandomState(0), BATCH)


def frozen_and_heads(model):
    """Copies of the trunk's tensors (amax buffers included) and of the
    head and text parameters, before the steps."""
    trunk = model.vision_encoder.model
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if not k.startswith("fc.")}
    heads = {"vision_encoder.model.fc.weight": trunk.fc.weight.detach().clone(),
             "text_encoder.embedding.weight":
                 model.text_encoder.embedding.weight.detach().clone()}
    return frozen, heads


def phase_resnext_slice():
    cfg, model, batch = build_resnext_slice(False, ("blocks",) * 4)
    trunk = model.vision_encoder.model
    frozen, heads = frozen_and_heads(model)

    state, train_step, (launches,) = drive(
        model, cfg, batch, [(fused_bottleneck, "launches")])
    forwards = TRAIN_STEPS + 1
    log(f"  K1 launches {launches} over {forwards} forwards")
    if launches != 16 * forwards:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{16 * forwards}")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(pooled):
            f = l2_normalize(trunk.fc(pooled), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        pooled = [trunk.forward_folded(img_bf16)["pooled"],
                  trunk.forward_conv(img_bf16)["pooled"],
                  trunk.forward_conv(img_f32)["pooled"]]
        compare_features("pooled", *pooled)
        compare_features("logits", *map(logits, pooled))

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        trunk_k = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        trunk_p = time_ms(lambda: trunk.forward_conv(img_aug), 10)
    log(f"  trunk forward B={BATCH}: K1 path {trunk_k:.3f} ms, plain bf16 "
        f"conv path {trunk_p:.3f} ms")
    time_steps(state, train_step, batch, "ResNeXt")
    return launches


def vit_frozen_and_heads(model):
    """Copies of the ViT's tensors and of the head and text parameters,
    before the steps."""
    trunk = model.vision_encoder.model
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if not k.startswith("head.")}
    layer = "text_encoder.transformer_encoder.layers.0."
    named = dict(model.named_parameters())
    heads = {k: named[k].detach().clone() for k in (
        "vision_encoder.model.head.weight", "text_encoder.embedding.weight",
        "text_encoder.pos_embed", layer + "self_attn.in_proj_weight",
        layer + "linear1.weight", layer + "norm2.weight")}
    return frozen, heads


def phase_vit_slice():
    cfg, model, batch = build_vit_slice()
    trunk = model.vision_encoder.model
    frozen, heads = vit_frozen_and_heads(model)
    # the state phase 6 restarts every configuration from
    start = {k: v.clone() for k, v in model.state_dict().items()}

    state, train_step, launches = drive(
        model, cfg, batch, [(fused_block_attention, "launches"),
                            (fused_mlp, "launches")])
    forwards = TRAIN_STEPS + 1
    log(f"  K5 launches {launches[0]}, K6 launches {launches[1]} over "
        f"{forwards} forwards")
    if launches != [VIT_DEPTH * forwards] * 2:
        raise AssertionError(f"K5/K6 launched {launches} times, expected "
                             f"{VIT_DEPTH * forwards} each")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(cls):
            f = l2_normalize(trunk.head(cls), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        cls = [trunk(img_bf16), trunk.forward_plain(img_bf16),
               trunk.forward_plain(img_f32)]
        compare_features("CLS", *cls)
        compare_features("logits", *map(logits, cls))

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        vit_k = time_ms(lambda: trunk(img_aug), 5)
        vit_p = time_ms(lambda: trunk.forward_plain(img_aug), 5)
    log(f"  ViT forward B={BATCH}: K5/K6 path {vit_k:.3f} ms, plain bf16 "
        f"path {vit_p:.3f} ms")
    time_steps(state, train_step, batch, "ViT")
    return launches, (cfg, model, batch, start)


def phase_vit_configs(cfg, model, batch, start):
    """Phase 4's model in each configuration of VIT_CONFIGS, each started
    from phase 4's initial weights (``start``), so that every
    configuration's eval gates are taken where phase 4's are: after 3 steps
    on one batch (training on from the last configuration sharpens the
    logits, and with them the bf16 noise the logits gate sees). Returns the
    launches of each ViT kernel in the configuration that runs it."""
    trunk = model.vision_encoder.model
    forwards = TRAIN_STEPS + 1
    counters = [(fn, "launches") for fn in VIT_KERNELS.values()]
    launches = {}
    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        # the frozen trunk's CLS in the default configuration, for the
        # opt-in modes' gates
        model.load_state_dict(start)
        trunk.vit_kernels = ViTKernels()
        default_cls = trunk(img_bf16), trunk.forward_plain(img_f32)
    for name, (kernels, per_forward) in VIT_CONFIGS.items():
        log(f"  -- {name}: {kernels}")
        model.load_state_dict(start)
        trunk.vit_kernels = kernels
        frozen, heads = vit_frozen_and_heads(model)
        state, train_step, counts = drive(model, cfg, batch, counters)
        got = dict(zip(VIT_KERNELS, counts))
        want = {k: per_forward.get(k, 0) * forwards for k in VIT_KERNELS}
        log(f"  launches over {forwards} forwards: {got}")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        launches.update({k: got[k] for k in per_forward if k[:2] in
                         ("K7", "K8")})
        check_frozen_and_heads(model, frozen, heads)

        with torch.no_grad():
            txt, _ = model.encode_text(batch["text"], batch["text_len"])

            def logits(cls):
                f = l2_normalize(trunk.head(cls), dim=1)
                return model.similarity(f, txt) * model.logit_scale()

            kern = trunk(img_bf16)
            with plain_kernels():
                plain = trunk(img_bf16)
            blocks = trunk.forward_plain(img_bf16)
            f32 = trunk.forward_plain(img_f32)
            if kernels.int8:
                int8_gates(name, trunk, img_bf16, kern, plain, default_cls[1],
                           logits)
            else:
                for what, ref in (("its plain versions", plain),
                                  ("the plain bf16 blocks", blocks)):
                    log(f"  against {what}:")
                    cls = [kern, ref, f32]
                    compare_features("CLS", *cls)
                    compare_features("logits", *map(logits, cls))
            if kernels.lnfold and not kernels.int8:
                cos = float(row_cosines(kern, default_cls[0]).min())
                log(f"  CLS against the default configuration: per-row "
                    f"cosine min {cos:.7f} (gate >= {SLICE_COS_TOL})")
                if not cos >= SLICE_COS_TOL:
                    raise AssertionError(f"{name}: CLS cosine {cos:.7f} to "
                                         f"the default configuration")
            fwd = time_ms(lambda: trunk(img_aug), 5)
        log(f"  ViT forward B={BATCH}, {name}: {fwd:.3f} ms")
        time_steps(state, train_step, batch, f"ViT {name}")
    vit_steps_in_turns(cfg, model, batch, start)
    trunk.vit_kernels = ViTKernels()
    return launches


def int8_gates(name, trunk, img, kern, plain, f32_default, logits):
    """The int8 ViT's gates, per row of the CLS features: cosine >= INT8_COS
    to the f32 plain path of the default configuration (the JAX package's
    envelope, tests/test_quant_trunk.py:535-537), and >= INT8_COS to the
    same int8 path with its kernels swapped for their plain versions (two
    int8 runs, each within the envelope: a bf16 rounding that the kernel
    moves can move an int8 code, which every later block carries, so the
    kernel path is held to int8's own noise and not to bf16's). Printed:
    the image -> text decisions against the plain versions on the rows
    whose plain top-two logit gap exceeds DECISION_GAP, and the int8 path's
    own sensitivity, its plain versions on the same frames with 1% of the
    pixels moved by about one bf16 ulp."""
    cos = row_cosines(kern, f32_default)
    cos_plain = row_cosines(kern, plain)
    lk, lp = logits(kern), logits(plain)
    top2 = lp.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > DECISION_GAP
    same = (lk.argmax(1) == lp.argmax(1))
    gen = torch.Generator(device=img.device).manual_seed(18)
    moved = torch.rand(img.shape, generator=gen, device=img.device) < 0.01
    img2 = torch.where(moved, (img.float() * (1 + 2 ** -7)).to(img.dtype),
                       img)
    with plain_kernels():
        cos_moved = row_cosines(trunk(img2), plain)
    log(f"  int8 CLS per row: against the f32 plain path of the default "
        f"configuration cosine min {float(cos.min()):.7f}, against its plain "
        f"versions min {float(cos_plain.min()):.7f} (gates >= {INT8_COS}); "
        f"the plain versions on 1% of the pixels moved by one ulp against "
        f"unmoved: min {float(cos_moved.min()):.7f}; decisions equal to the "
        f"plain versions' on {int((same & clear).sum())} of the "
        f"{int(clear.sum())} rows with a top-two gap > {DECISION_GAP} "
        f"({int(same.sum())} of {len(same)} rows in all)")
    if not (torch.isfinite(kern).all() and float(cos.min()) >= INT8_COS
            and float(cos_plain.min()) >= INT8_COS):
        raise AssertionError(f"{name}: cosine {float(cos.min()):.7f} to f32, "
                             f"{float(cos_plain.min()):.7f} to plain")


def vit_steps_in_turns(cfg, model, batch, start):
    """The ViT train step of each configuration of VIT_TURNS (default: K5
    + K6; attn=1: K8a + K6; attn=pairs: K8b + K6; attn=qkv: K8c + K6;
    whole_block: K7), each from phase 4's weights with an optimizer state
    of its own, timed in turns (the list, then the list reversed;
    TIMED_STEPS steps a turn) on one model whose ``vit_kernels`` is
    switched before each turn."""
    trunk = model.vision_encoder.model
    model.load_state_dict(start)
    runs = {}
    for name, kernels in VIT_TURNS.items():
        trunk.vit_kernels = kernels
        state, step = init_train_state(model, cfg), make_train_step(model, cfg)
        step(state, batch)  # untimed: first use of the configuration
        runs[name] = (kernels, state, step)
    times = collections.defaultdict(list)
    for name in list(VIT_TURNS) + list(VIT_TURNS)[::-1]:
        kernels, state, step = runs[name]
        trunk.vit_kernels = kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    for name, ms in times.items():
        log(f"  ViT train step B={BATCH} in turns, {name}: "
            f"{' / '.join(f'{t:.3f}' for t in ms)} ms (mean "
            f"{sum(ms) / len(ms):.3f})")


@contextlib.contextmanager
def plain_kernels():
    """The trunks' kernels replaced by their plain versions, on CUDA tensors
    (the wrappers themselves take those only for CPU tensors)."""
    def block(x, fw, stride=1):
        return block_reference(x, fw, stride=stride)

    def stage(x, fws, strides, band=None):
        return stage_reference(x, fws, strides)

    plain = {
        vision_resnext: {"fused_bottleneck": block, "fused_stage": stage,
                         "fused_stage_banded": stage},
        vision_vit: {"fused_block_attention": block_attention_reference,
                     "fused_mlp": mlp_reference,
                     "fused_vit_block": vit_block_reference,
                     "fused_attention": attention_reference,
                     "fused_attention_pairs": attention_pairs_reference,
                     "fused_qkv_attention_pairs":
                         qkv_attention_pairs_reference}}
    saved = [(m, n, getattr(m, n)) for m, fns in plain.items() for n in fns]
    for m, fns in plain.items():
        for n, fn in fns.items():
            setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def phase_published_flagship():
    cfg, model, batch = build_resnext_slice(MIXED, None)
    trunk = model.vision_encoder.model
    log(f"  plans: int8 {trunk.int8_plan}, kernels {trunk.fused_plan}")
    t0 = time.perf_counter()
    calibrate_trunk(model, batch)
    torch.cuda.synchronize()
    log(f"  calibrated on 32 augment-off frames in "
        f"{time.perf_counter() - t0:.2f} s: stem_amax "
        f"{float(trunk.stem_amax):.4f}, layer3.0 h1_amax "
        f"{float(trunk.layer3[0].h1_amax):.4f}, layer4.2 out_amax "
        f"{float(trunk.layer4[2].out_amax):.4f}")
    frozen, heads = frozen_and_heads(model)

    counters = [(fused_bottleneck, "launches"),
                (fused_bottleneck, "launches_q"),
                (fused_stage, "launches"), (fused_stage_banded, "launches")]
    state, train_step, launches = drive(model, cfg, batch, counters)
    forwards = TRAIN_STEPS + 1
    want = [4 * forwards, forwards, 2 * forwards, forwards]
    log(f"  launches over {forwards} forwards: K1 {launches[0]}, K2 "
        f"{launches[1]}, K3a {launches[2]}, K3b {launches[3]}")
    if launches != want:
        raise AssertionError(f"K1/K2/K3a/K3b launched {launches} times, "
                             f"expected {want}")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(pooled):
            f = l2_normalize(trunk.fc(pooled), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        kernels = trunk.forward_folded(img_bf16)["pooled"]
        with plain_kernels():
            plain = trunk.forward_folded(img_bf16)["pooled"]
        f32 = trunk.forward_conv(img_f32)["pooled"]
        pooled = [kernels, plain, f32]
        compare_features("pooled", *pooled)
        compare_features("logits", *map(logits, pooled))
        cos_f32 = float(row_cosines(kernels, f32).min())
        log(f"  int8 plan pooled vs the f32 conv path: per-row cosine min "
            f"{cos_f32:.7f} (gate > 0.99)")
        if not cos_f32 > 0.99:
            raise AssertionError(f"pooled cosine vs f32 {cos_f32:.7f}")

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        t_int8 = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        plans = trunk.int8_plan, trunk.fused_plan
        trunk.int8_plan, trunk.fused_plan = (False,) * 4, ("blocks",) * 4
        t_k1 = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        trunk.int8_plan, trunk.fused_plan = plans
        t_conv = time_ms(lambda: trunk.forward_conv(img_aug), 10)
    log(f"  trunk forward B={BATCH}: int8 published plan {t_int8:.3f} ms, "
        f"bf16 per-block K1 path {t_k1:.3f} ms, plain bf16 conv path "
        f"{t_conv:.3f} ms")
    step_s = time_steps(state, train_step, batch, "published flagship")
    return launches, (state, train_step, batch), step_s


# ------------------------------------------------------------------ phase 7

def recipe_cfg(lambda_mm: float, lambda_lm: float) -> ExperimentConfig:
    """configs/saycam_contrastive.py with the lstm text encoder (lambda_mm
    1), saycam_joint.py (0.5 and 0.5) or saycam_lm.py (lambda_lm 1) on
    phase 5's published trunk: dropout_i 0.5 (configs/_base.py), flat
    head, fixed T = 0.07, tied LM head with bias, unused terms skipped."""
    cfg = flagship_cfg(vit=False, trunk_int8=MIXED)
    cfg.model.text = TextConfig(text_encoder="lstm", dropout_i=0.5)
    cfg.train.lambda_mm, cfg.train.lambda_lm = lambda_mm, lambda_lm
    cfg.train.optimize_unused = True
    return cfg


def build_lstm_slice():
    """(cfg, model, batch) of phase 7a: the published trunk, seeded and
    calibrated as in phase 5, with the LSTM text encoder."""
    cfg, model, batch = build_resnext_slice(MIXED, None, recipe_cfg(1.0, 0.0))
    calibrate_trunk(model, batch)
    return cfg, model, batch


def lstm_heads(model):
    named = dict(model.named_parameters())
    return {k: named[k].detach().clone() for k in (
        "vision_encoder.model.fc.weight", "text_encoder.embedding.weight",
        "text_encoder.lstm.weight_hh_l0", "language_model.output_layer.bias")}


def make_lm_batch(rng, b, length):
    """Token ids in a window of ``length`` steps: SOS, words, EOS, PAD."""
    text = np.zeros((b, length), np.int64)
    lens = rng.randint(1, length - 1, b)
    lens[0] = length - 2
    text[:, 0] = 2
    for i, n in enumerate(lens):
        text[i, 1:1 + n] = rng.randint(4, VOCAB, n)
        text[i, 1 + n] = 3
    return {"text": torch.from_numpy(text).cuda(),
            "text_len": torch.from_numpy(lens + 2).cuda()}


def phase_lstm_slice():
    """7a: the LSTM contrastive recipe with fused_lstm None and True from
    the same weights, gated against each other; the biLSTM; infonce_loss
    (K4) on the eval features. 7b: the joint recipe and beam search. 7c:
    the LM recipe at L = 64. Returns the K9 launches and K4's forward and
    backward launches, counted from 0 over the whole phase."""
    cfg, model, batch = build_lstm_slice()
    frozen, _ = frozen_and_heads(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    forwards = TRAIN_STEPS + 1
    counters = [(lstm_fused, "launches"),
                (fused_infonce_with_metrics, "launches"),
                (fused_infonce_with_metrics, "launches_bwd")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    total = [0, 0, 0]
    img_eval = augment_batch(batch["image_u8"], augment=False,
                             dtype=torch.bfloat16)
    evals = {}
    for fused in (None, True):
        log(f"  -- 7a lstm contrastive, fused_lstm={fused}")
        model.load_state_dict(start)
        model.text_encoder.fused_lstm = fused
        heads = lstm_heads(model)
        del heads["language_model.output_layer.bias"]  # no LM term
        state, train_step, (k9,) = drive(model, cfg, batch,
                                         [(lstm_fused, "launches")])
        want = forwards if fused else 0
        log(f"  K9 launches {k9} over {forwards} forwards")
        if k9 != want:
            raise AssertionError(f"fused_lstm={fused}: K9 launched {k9} "
                                 f"times, expected {want}")
        total[0] += k9
        check_frozen_and_heads(model, frozen, heads)
        with torch.no_grad():
            out = model.joint_forward(img_eval, batch["text"],
                                      batch["text_len"])
            txt, _ = model.encode_text(batch["text"], batch["text_len"])
            metrics = make_eval_step(model, cfg)(batch)
        evals[fused] = (out["image_features"], txt, out["logits_per_image"],
                        metrics)
        time_steps(state, train_step, batch, f"LSTM fused_lstm={fused}")
    (_, txt0, log0, _), (img1, txt1, log1, m1) = evals[None], evals[True]
    for what, a, b, tol in (("text features", txt1, txt0, COS_TOL),
                            ("logits", log1, log0, SLICE_COS_TOL)):
        cos = row_cosines(a, b)
        log(f"  eval {what}: fused_lstm=True against None: per-row cos min "
            f"{float(cos.min()):.7f} (gate >= {tol})")
        if not (torch.isfinite(a).all() and float(cos.min()) >= tol):
            raise AssertionError(f"7a eval {what}: cosine "
                                 f"{float(cos.min()):.7f} < {tol}")

    # K4 through the entry point on 7a's eval features
    nlt = model.logit_neg_log_temperature.detach()
    leaves = [t.detach().clone().requires_grad_() for t in (img1, txt1, nlt)]
    loss_k = infonce_loss(*leaves)
    grads_k = torch.autograd.grad(loss_k, leaves)
    plain = [t.detach().clone().requires_grad_() for t in (img1, txt1, nlt)]
    logits = plain[2].exp() * (plain[0] @ plain[1].T)
    loss_p, _ = contrastive_loss_from_logits(logits, logits.T)
    grads_p = torch.autograd.grad(loss_p, plain)
    step_loss = float(m1["infonce_loss"])
    rel = abs(float(loss_k) - step_loss) / abs(step_loss)
    log(f"  infonce_loss (K4) on the eval features {float(loss_k):.7f}, the "
        f"eval step's infonce_loss {step_loss:.7f}: rel err {rel:.3g}")
    if not rel <= 1e-5:
        raise AssertionError(f"K4 loss {float(loss_k)} != the step's "
                             f"{step_loss}")
    for name, a, b in zip(("d_img", "d_txt", "d_neg_log_temp"), grads_k,
                          grads_p):
        err = float((a - b).abs().max())
        log(f"  K4 {name} against autograd through the plain loss: max abs "
            f"err {err:.3g}")
        if not torch.allclose(a, b, atol=1e-4, rtol=1e-3):
            raise AssertionError(f"K4 {name}: outside atol 1e-4, rtol 1e-3")

    # the biLSTM encoder: one eval forward, both directions through K9
    bi_cfg = recipe_cfg(1.0, 0.0)
    bi_cfg.model.text.text_encoder = "bilstm"
    bi = TextEncoder(bi_cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(3),
                     fused_lstm=True)
    before = lstm_fused.launches
    with torch.no_grad():
        feats, _ = bi(batch["text"], batch["text_len"])
        n_bi = lstm_fused.launches - before
        bi.fused_lstm = False
        feats_plain, _ = bi(batch["text"], batch["text_len"])
    cos = row_cosines(feats, feats_plain)
    log(f"  biLSTM eval forward: {n_bi} K9 launches; features against the "
        f"plain scan: per-row cos min {float(cos.min()):.7f}")
    if n_bi != 2 or float(cos.min()) < COS_TOL:
        raise AssertionError(f"biLSTM: {n_bi} K9 launches (expected 2), "
                             f"cos {float(cos.min()):.7f}")
    total[0] += n_bi

    log("  -- 7b joint recipe (lambda_mm = lambda_lm = 0.5), fused_lstm=True")
    cfg_b = recipe_cfg(0.5, 0.5)
    model.load_state_dict(start)
    model.text_encoder.fused_lstm = True
    heads = lstm_heads(model)
    state, train_step, (k9,) = drive(model, cfg_b, batch,
                                     [(lstm_fused, "launches")],
                                     show=("infonce_loss", "ce_loss",
                                           "ce_loss_wo_sos",
                                           "ce_loss_wo_sos_eos", "n_tokens"))
    log(f"  K9 launches {k9} over {forwards} forwards")
    if k9 != forwards:
        raise AssertionError(f"7b: K9 launched {k9} times, expected "
                             f"{forwards}")
    total[0] += k9
    check_frozen_and_heads(model, frozen, heads)
    joint_state = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
    time_steps(state, train_step, batch, "joint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, scores = model.beam_search_decode(8, beam_width=3, decode_length=25)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    # a row returns its finished hypotheses, padded with empty slots
    # (score NEG_INF), or its alive beams when none finished
    found = int((scores > NEG_INF / 2).sum())
    log(f"  beam search, 8 sequences, width 3, length 25: {beam_s * 1e3:.1f} "
        f"ms; best: {seq[0, 0, :12].tolist()}..., best scores "
        f"{scores[:, 0].tolist()}; {found} of 24 slots hold a hypothesis")
    if not (seq.shape == (8, 3, 26) and bool((seq[:, 0, 0] == 2).all())
            and bool((scores[:, 0] > NEG_INF / 2).all())):
        raise AssertionError(f"beam search: {tuple(seq.shape)}, scores "
                             f"{scores.tolist()}")

    log(f"  -- 7c LM recipe (lambda_mm = 0) at L = {LM_LEN}, fused_lstm=None")
    cfg_c = recipe_cfg(0.0, 1.0)
    model.load_state_dict(start)
    model.text_encoder.fused_lstm = None
    heads = lstm_heads(model)
    lm_batch = make_lm_batch(np.random.RandomState(5), BATCH, LM_LEN)
    state, train_step, (k9,) = drive(model, cfg_c, lm_batch,
                                     [(lstm_fused, "launches")],
                                     show=("ce_loss", "n_tokens"))
    log(f"  K9 launches {k9} over {forwards} forwards")
    if k9 != forwards:
        raise AssertionError(f"7c: K9 launched {k9} times, expected "
                             f"{forwards}")
    total[0] += k9
    check_frozen_and_heads(model, frozen, heads)
    time_steps(state, train_step, lm_batch, f"LM L={LM_LEN}")
    total[1:] = [fused_infonce_with_metrics.launches,
                 fused_infonce_with_metrics.launches_bwd]
    log(f"  phase 7 launches: K9 {total[0]}, K4 forward {total[1]}, K4 "
        f"backward {total[2]}")
    return total, (model, joint_state)


# ---------------------------------------------------------------- phase 2f

# the transport blocks and stages of the "t" plan at 224 px: (name, H, Cin,
# width, Cout, stride(s), downsample or band, per forward)
T_BLOCKS_224 = [
    ("layer2.0", 56, 256, 256, 512, 2, True, 1),
    ("layer2.1", 28, 512, 256, 512, 1, False, 3),
    ("layer3.0", 28, 512, 512, 1024, 2, True, 1),
]
T_STAGES_224 = [
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], None),
    ("layer1", 56, 64, 128, 256, [1, 1, 1], 28),
]
# K10b: (name, B, H, Cin, width, Cout, stride, downsample, Bc, hh); hh None
# = the TPU package's default band; every block shape at B = 8, then layer
# 2's head at the slice's batch (timed)
TILES_CASES = [
    ("tests/test_hwbc_kernels.py:74", 32, 16, 128, 256, 512, 2, True, 16,
     2)] + [
    (name, 8, H, cin, width, cout, s, ds, 8, (H - 1) // s + 1)
    for name, H, cin, width, cout, s, ds, _ in BLOCKS_224] + [
    ("layer2.0", BATCH, 56, 256, 256, 512, 2, True, 16, None)]


def random_t_block(gen, cin, width, cout, has_ds):
    """int8-transport folded weights of one block on the card (amax as
    tests/test_quant_trunk.py:228: in 2.0, out 2.5)."""
    fw = fold_block_params_t(random_block_state(gen, cin, width, cout,
                                                has_ds), 2.0, 2.5)
    return {k: v.cuda() for k, v in fw.items()}


def transport_chain(fw, stride):
    """The library chain for K10a: the codes as bf16 (the input scale rides
    in w1 and wd), cuDNN bf16 convolutions channels-last, then the output
    scale and the rounding as torch elementwise ops."""
    cl = torch.channels_last

    def conv_w(w):  # [in, out] -> [out, in, 1, 1]
        return w.t()[:, :, None, None].contiguous(memory_format=cl)

    cw = {k: conv_w(fw[k]) for k in ("w1", "w3", "wd") if k in fw}
    w2 = fw["w2"].permute(3, 2, 0, 1).contiguous(memory_format=cl)
    b1, b2 = fw["b1"].to(torch.bfloat16), fw["b2"].to(torch.bfloat16)

    def run(x):
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, codes
        h = F.relu(F.conv2d(xc, cw["w1"], b1))
        h = F.relu(F.conv2d(h, w2, b2, stride=stride, padding=1, groups=32))
        y = F.conv2d(h, cw["w3"]).float().permute(0, 2, 3, 1)
        y = y * fw["a3"] + fw["b3"]
        if "wd" in cw:
            ident = (F.conv2d(xc, cw["wd"], stride=stride).float()
                     .permute(0, 2, 3, 1) * fw["ad"] + fw["bd"])
        else:
            ident = x.float() * fw["ai"]
        return torch.round(y + ident).clamp_(0, 127).to(torch.int8)

    return run


def check_transport_stage(what, got, x, fws, strides) -> float:
    """A transport stage's codes: equal to the chain of its blocks' K10a
    launches (the same tile routines in the same order), each of those
    within check_codes' envelope of its plain version on the same input,
    and the whole against the plain chain at cosine >= 0.9999 (a code that
    one rounding moves rides the residual path into the next block, so the
    chain's differences add up; their count is printed). Returns the max
    abs error against the plain chain, in codes."""
    y = x
    for j, (fw, st) in enumerate(zip(fws, strides)):
        want = bottleneck_reference_t(y, fw, stride=st)
        y = fused_bottleneck(y, fw, stride=st)
        check_codes(f"{what} block {j}", y, want)
    torch.cuda.synchronize()
    same = int((got != y).sum())
    log(f"  {what}: {same} codes differ from the chain of K10a block "
        f"launches (0 expected)")
    if same:
        raise AssertionError(f"{what}: {same} codes differ from the "
                             f"per-block kernels")
    want = stage_reference(x, fws, strides)
    diff = (got.int() - want.int()).abs()
    cos = cosine(got, want)
    log(f"  {what:34s} against its plain chain: {int((diff > 0).sum())} of "
        f"{diff.numel()} codes differ (max {int(diff.max())}), cos "
        f"{cos:.7f}")
    if not cos >= COS_TOL:
        raise AssertionError(f"{what}: cos {cos:.7f} against the plain chain")
    return float(diff.max())


def phase_transport_kernels():
    """K10a (block, stage, banded stage), K10b and K11 against their plain
    versions, then timed beside the plain versions, the library calls and
    the bounds. Returns the kernel rows (launches filled in by phase 8)."""
    gen = torch.Generator().manual_seed(6)
    gen_bf16 = torch.Generator().manual_seed(60)  # K1's and K3a/K3b's inputs
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
            for k in ("K10a block", "K10a stage", "K10a banded")}
    for name, H, cin, width, cout, s, ds, count in T_BLOCKS_224:
        fw = random_t_block(gen, cin, width, cout, ds)
        x = random_codes(gen, BATCH, H, cin)
        r = rows["K10a block"]
        r["max_abs_err"] = max(r["max_abs_err"], check_codes(
            f"K10a {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_t(x, fw, stride=s)))
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference_t(x, fw, stride=s),
            lambda: transport_chain(fw, s)(x), 20)
        ops, act = block_cost(H, cin, width, cout, s, ds, BATCH)
        b_ms, b_by = launch_bound(r, ops, act + weight_bytes([fw]), count)
        xb, fwb = random_block(gen_bf16, H, cin, width, cout, s, ds, BATCH)
        k1 = time_ms(lambda: fused_bottleneck(xb, fwb, stride=s), 20)
        log(f"  K10a {name} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TFLOP/s; K1 at this block shape "
            f"{k1:.3f} ms")
        del xb, fwb
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += count * v
        del x, fw

    for name, H, cin, width, cout, strides, band in T_STAGES_224:
        fws = []
        for j, st in enumerate(strides):
            c = cin if j == 0 else cout
            fws.append(random_t_block(gen, c, width, cout,
                                      j == 0 and (c != cout or st != 1)))
        x = random_codes(gen, BATCH, H, cin)
        row = "K10a stage" if band is None else "K10a banded"

        def kernel():
            return (fused_stage(x, fws, strides) if band is None
                    else fused_stage_banded(x, fws, strides, band))

        def plain():
            return stage_reference(x, fws, strides)

        desc = f"{row} {name}" + (f" N={band}" if band else "")
        rows[row]["max_abs_err"] = max(
            rows[row]["max_abs_err"],
            check_transport_stage(desc, kernel(), x, fws, strides))
        chains = [transport_chain(fw, st) for fw, st in zip(fws, strides)]

        def library():
            y = x
            for chain in chains:
                y = chain(y)
            return y

        k, p, li = time_in_turns(kernel, plain, library, 10)
        ops, nbytes = stage_cost(H, cin, width, cout, strides, fws, BATCH)
        nbytes -= BATCH * (H * H * cin + (H // strides[0]) ** 2 * cout)
        r = rows[row]  # int8 activations: 1 byte each
        b_ms, b_by = launch_bound(r, ops, nbytes)
        # the bf16 body at the same stage (K3a's, or K3b at the same band)
        xb, fwb = stage_inputs(gen_bf16, H, cin, width, cout, strides, False,
                               BATCH)
        bf16 = time_ms(lambda: fused_stage(xb, fwb, strides) if band is None
                       else fused_stage_banded(xb, fwb, strides, band), 10)
        log(f"  {desc} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TFLOP/s; the bf16 body ("
            f"{'K3a' if band is None else 'K3b'}) at this stage {bf16:.3f} "
            f"ms")
        del xb, fwb
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += v
        del x, fws, chains
    for name, r in rows.items():
        log(f"  {name} per B={BATCH} forward of the \"t\" plan: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms summed "
            f"per launch ({r['bound_by']})")

    # K10b: K1's function in one launch, h1 and h2 in shared memory
    for name, B, H, cin, width, cout, s, ds, Bc, hh in TILES_CASES:
        hh = hh or default_band(H, cin, (H - 1) // s + 1, s, Bc)
        x, fw = random_block(gen, H, cin, width, cout, s, ds, B)
        before = fused_bottleneck_tiles.launches
        got = fused_bottleneck_tiles(x, fw, s, Bc, hh)
        if fused_bottleneck_tiles.launches != before + 1:
            raise AssertionError(f"K10b {name}: "
                                 f"{fused_bottleneck_tiles.launches - before}"
                                 f" launches, expected 1")
        err = check(f"K10b {name}", got, tiles_reference(x, fw, s, Bc, hh))
        k1 = fused_bottleneck(x, fw, stride=s)
        torch.cuda.synchronize()
        apart = float((got.float() - k1.float()).abs().max() /
                      k1.float().abs().max())
        ulps = (got.view(torch.int16).int() -
                k1.view(torch.int16).int()).abs()
        log(f"  K10b {name}: against K1, max error relative to K1's largest "
            f"output {apart:.3g} (gate < 5e-5, tests/test_hwbc_kernels.py:"
            f"22), {float((ulps > 0).float().mean()):.3g} of the outputs "
            f"differ, by at most {int(ulps.max())} bf16 ulps")
        if not apart < 5e-5:
            raise AssertionError(f"K10b {name}: {apart} from K1")
        if B != BATCH:
            continue
        lib = conv_chain(fw, s)
        k1_ms = [time_ms(lambda: fused_bottleneck(x, fw, stride=s), 10)]
        k, p, li = time_in_turns(
            lambda: fused_bottleneck_tiles(x, fw, s, Bc, hh),
            lambda: tiles_reference(x, fw, s, Bc, hh),
            lambda: lib(x), 10)
        k1_ms.append(time_ms(lambda: fused_bottleneck(x, fw, stride=s), 10))
        ops, act = block_cost(H, cin, width, cout, s, ds, B)
        b_ms, b_by = bound(ops, 2 * act + weight_bytes([fw]))
        log(f"  K10b {name} B={B}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"cuDNN bf16 {li:.3f} ms, K1 {k1_ms[0]:.3f} / {k1_ms[1]:.3f} "
            f"ms (before / after), bound {b_ms:.3f} ms ({b_by}); "
            f"{tiles_geometry(H, H, cin, width, cout, s, ds)}")
        rows["K10b"] = dict(max_abs_err=err, ms=k, plain_ms=p, library_ms=li,
                            bound_ms=b_ms, bound_by=b_by)
        del x, fw, lib

    # K11: every conv3 shape of a B = 128 forward
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    for name, H, _, width, cout, s, _, count in BLOCKS_224:
        Ho = (H - 1) // s + 1
        M = BATCH * Ho * Ho
        x = torch.randn(M, width, generator=gen).clamp_min(0).to(
            "cuda", torch.bfloat16)
        w = (torch.randn(width, cout, generator=gen) / width ** 0.5).to(
            "cuda", torch.bfloat16)
        mul = (0.5 + torch.rand(cout, generator=gen)).cuda()
        add = (0.1 * torch.randn(cout, generator=gen)).cuda()
        res = torch.randn(M, cout, generator=gen).to("cuda", torch.bfloat16)
        args = (x, w, mul, add, res)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"K11 {name} conv3 M={M}", conv1x1_bn_residual_relu(*args),
            epilogue_reference(*args)))
        if name in ("layer1.0", "layer4.0"):  # the backward
            leaves = [t.clone().requires_grad_() for t in args]
            plain_leaves = [t.clone().requires_grad_() for t in args]
            g = torch.randn(M, cout, generator=gen).to("cuda", torch.bfloat16)
            got = torch.autograd.grad(conv1x1_bn_residual_relu(*leaves),
                                      leaves, g)
            want = torch.autograd.grad(epilogue_reference(*plain_leaves),
                                       plain_leaves, g)
            for gname, a, b in zip(("x", "w", "mul", "add", "residual"), got,
                                   want):
                if not torch.equal(a, b):  # both the plain autograd
                    raise AssertionError(f"K11 {name} d{gname} differs")
            log(f"  K11 {name}: the gradients of x, w, mul, add and the "
                f"residual equal the plain version's autograd")

        def library():
            y = torch.matmul(x, w).float() * mul + add + res.float()
            return torch.relu(y).to(torch.bfloat16)

        k, p, li = time_in_turns(lambda: conv1x1_bn_residual_relu(*args),
                                 lambda: epilogue_reference(*args),
                                 library, 20)
        ops = 2 * M * width * cout
        nbytes = 2 * (M * width + 2 * M * cout + width * cout) + 8 * cout
        b_ms, b_by = launch_bound(r, ops, nbytes, count)
        log(f"  K11 {name} conv3 M={M} Cin={width} Cout={cout}: kernel "
            f"{k:.3f} ms, plain {p:.3f} ms, matmul chain {li:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by})")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += count * v
        del x, w, res, args
    log(f"  K11 over the 16 conv3 of one B={BATCH} forward: kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, matmul chain "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms summed per "
        f"launch ({r['bound_by']})")
    rows["K11"] = r
    return rows


# ------------------------------------------------------------------ phase 8

T_PLANS = {  # trunk_int8 -> launches per forward by counter
    "t": {"K10a block": 5, "K10a stage": 2, "K10a banded": 1},
    "t,t,1,1": {"K10a block": 4, "K10a banded": 1, "K2": 1, "K3a": 2},
}
T_COUNTERS = {
    "K1": (fused_bottleneck, "launches"), "K2": (fused_bottleneck,
                                                 "launches_q"),
    "K10a block": (fused_bottleneck, "launches_t"),
    "K3a": (fused_stage, "launches"), "K10a stage": (fused_stage,
                                                     "launches_t"),
    "K3b": (fused_stage_banded, "launches"),
    "K10a banded": (fused_stage_banded, "launches_t"),
}


def phase_transport_slice(published):
    """8a/8b: phase 5's published model under trunk_int8 "t" and
    ("t", "t", "q", "q"), calibrated once, 3 train and 1 eval steps each,
    gated as phase 5; then the step times of both and of phase 5's
    (``published``: (state, train_step, batch)) in turns. 8c: the entry
    points of K10b and K11. Returns the launches by kernel row."""
    forwards = TRAIN_STEPS + 1
    launches = collections.Counter()
    timed = {"published \"0,0,1,1\"": published}
    for plan, per_forward in T_PLANS.items():
        log(f"  -- trunk_int8={plan!r}, default kernel plan")
        cfg, model, batch = build_resnext_slice(plan, None)
        trunk = model.vision_encoder.model
        calibrate_trunk(model, batch)
        frozen, heads = frozen_and_heads(model)
        state, train_step, counts = drive(model, cfg, batch,
                                          list(T_COUNTERS.values()))
        got = dict(zip(T_COUNTERS, counts))
        want = {k: per_forward.get(k, 0) * forwards for k in T_COUNTERS}
        log(f"  launches over {forwards} forwards: {got}")
        if got != want:
            raise AssertionError(f"{plan}: launches {got}, expected {want}")
        launches.update({k: v for k, v in got.items() if k[:3] == "K10"})
        check_frozen_and_heads(model, frozen, heads)
        with torch.no_grad():
            img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                     dtype=torch.bfloat16)
            img_f32 = augment_batch(batch["image_u8"], augment=False)
            txt, _ = model.encode_text(batch["text"], batch["text_len"])

            def logits(pooled):
                f = l2_normalize(trunk.fc(pooled), dim=1)
                return model.similarity(f, txt) * model.logit_scale()

            kernels = trunk.forward_folded(img_bf16)["pooled"]
            with plain_kernels():
                plain = trunk.forward_folded(img_bf16)["pooled"]
            f32 = trunk.forward_conv(img_f32)["pooled"]
            compare_features("pooled", kernels, plain, f32)
            compare_features("logits", *map(logits, (kernels, plain, f32)))
            cos_f32 = float(row_cosines(kernels, f32).min())
            log(f"  {plan} pooled vs the f32 conv path: per-row cosine min "
                f"{cos_f32:.7f} (gate > 0.99)")
            if not cos_f32 > 0.99:
                raise AssertionError(f"pooled cosine vs f32 {cos_f32:.7f}")
            img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
            fwd = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        log(f"  trunk forward B={BATCH}, trunk_int8={plan!r}: {fwd:.3f} ms")
        timed[plan] = (state, train_step, batch)
    log("  step times in turns (published, t, t,t,1,1, then back):")
    order = list(timed) + list(timed)[::-1]
    for what in order:
        time_steps(*timed[what], f"trunk_int8={what}")

    log("  -- 8c the entry points of K10b and K11")
    x, fw = random_block(torch.Generator().manual_seed(8), 56, 256, 256, 512,
                         2, True, BATCH)
    fused_bottleneck_tiles.launches = 0
    got = fused_bottleneck_tiles(x, fw, 2)
    n_tiles = fused_bottleneck_tiles.launches
    check("K10b layer2.0 entry point", got, fused_bottleneck(x, fw, 2))
    log(f"  fused_bottleneck_tiles(layer2.0, B={BATCH}, Bc 16, default "
        f"band): {n_tiles} launch(es)")
    if n_tiles != 1:
        raise AssertionError(f"K10b: {n_tiles} launches a call, expected 1")
    launches["K10b"] = n_tiles
    cfg, model, batch = build_resnext_slice(False, None)
    trunk = model.vision_encoder.model
    for block in trunk.blocks():
        block.fused_epilogue = True
    conv1x1_bn_residual_relu.launches = 0
    with torch.no_grad():
        img = augment_batch(batch["image_u8"], augment=False,
                            dtype=torch.bfloat16)
        fused = trunk.forward_conv(img)["pooled"]
        n_k11 = conv1x1_bn_residual_relu.launches
        for block in trunk.blocks():
            block.fused_epilogue = False
        conv = trunk.forward_conv(img)["pooled"]
        cos = row_cosines(fused, conv)
    log(f"  conv path with BottleneckX(fused_epilogue=True): {n_k11} K11 "
        f"launches per forward; pooled against the conv path without it: "
        f"per-row cos min {float(cos.min()):.7f} (gate >= {SLICE_COS_TOL})")
    if n_k11 != 16 or float(cos.min()) < SLICE_COS_TOL:
        raise AssertionError(f"K11: {n_k11} launches, cos "
                             f"{float(cos.min()):.7f}")
    launches["K11"] = n_k11
    return launches


# ------------------------------------------------------------------ phase 9

# Labeled-S categories of the packaged vocabulary, one per base image
EVAL_CATS = ("ball", "basket", "car", "cat", "chair", "computer", "crib",
             "floor", "foot", "ground", "kitchen", "paper", "puzzle", "road",
             "sand", "window")
EVAL_TRIALS = 257    # at EVAL_BATCH: four full chunks and a tail of one
EVAL_BATCH = 64
VIT_EVAL_TRIALS = 65
PROBE_FRAMES = 512
EVAL_GAP = 0.05      # decisions equal where the plain top-two gap exceeds it
EVAL_AGREE = 0.99    # and on this share of all trials
# (K1, K2, K3a, K3b) launches per trunk forward: the default plan in bf16,
# and the published int8 plan (B % 32 == 0)
PLAN_BF16 = [5, 0, 2, 1]
PLAN_INT8 = [4, 1, 2, 1]
RESNEXT_COUNTERS = [(fused_bottleneck, "launches"),
                    (fused_bottleneck, "launches_q"),
                    (fused_stage, "launches"),
                    (fused_stage_banded, "launches")]
VIT_COUNTERS = [(fused_block_attention, "launches"), (fused_mlp, "launches")]


def eval_frames(rng, per_base, size=224):
    """uint8 frames [16 * per_base, size, size, 3]: 16 coarse random
    textures (8 px cells), each frame with its own noise; and each frame's
    base index."""
    bases = rng.randint(0, 256, (16, size // 8, size // 8, 3)).astype(
        np.int16).repeat(8, 1).repeat(8, 2)
    labels = np.repeat(np.arange(16), per_base)
    noise = rng.randint(-24, 25, (labels.size, size, size, 3)).astype(
        np.int16)
    return (np.clip(bases[labels] + noise, 0, 255).astype(np.uint8), labels)


def fit_head(model, frames, labels, vocab, categories=EVAL_CATS):
    """Set the vision head (``fc`` or ``head``) by least squares so that
    each category's mean f32 trunk feature, less the mean over all
    ``frames``, maps to its label's text features (the eval's labels,
    <sos> word <eos>), as a trained head would place them: a random
    trunk's features of different images lie close together (the
    category means' least pairwise cosine is printed), so with a random
    head every trial is a near-tie. ``labels`` index ``categories``."""
    trunk = model.vision_encoder.model
    vit = model.cfg.vision.vit_dino
    n = len(categories)
    ids = torch.zeros((n, MAX_LEN_UTTERANCE), dtype=torch.long)
    ids[:, 0], ids[:, 2] = 2, 3
    ids[:, 1] = torch.tensor([vocab[c] for c in categories])
    with torch.no_grad(), trunk_path(model, "f32"):
        x = normalize_image(torch.from_numpy(frames).cuda())
        feats = (trunk(x) if vit else trunk(x)["pooled"]).double()
        text = model.encode_text(ids.cuda(), torch.full(
            (n,), 3, device="cuda"))[0].double()
        mean = feats.mean(0)
        delta = torch.stack([feats[torch.from_numpy(labels == c).cuda()]
                             .mean(0) for c in range(n)]) - mean
        w = text.T @ torch.linalg.pinv(delta.T)
        means = F.normalize(delta + mean, dim=1)
        log(f"  {'ViT' if vit else 'ResNeXt'} head fitted to {n} categories: "
            f"their mean f32 trunk features at pairwise cosine >= "
            f"{float((means @ means.T).min()):.7f}")
        head = trunk.head if vit else trunk.fc
        head.weight.copy_(w.float())
        head.bias.copy_(-(w @ mean).float())


def write_eval_set(root, rng, frames, labels, n_trials=EVAL_TRIALS,
                   ext=".png"):
    """The 64 frames (4 per category) as PNG (or JPEG at quality 90, ext
    ".jpg") and ``n_trials`` trials over them (eval_filtered_dev.json):
    target t % 16, three foil categories drawn without replacement, a
    random frame of each."""
    from PIL import Image
    paths = {c: [] for c in EVAL_CATS}
    for i, (frame, label) in enumerate(zip(frames, labels)):
        path = root / f"{EVAL_CATS[label]}_{i % 4}{ext}"
        Image.fromarray(frame).save(path, **(
            {"quality": 90} if ext == ".jpg" else {}))
        paths[EVAL_CATS[label]].append(str(path))
    trials = []
    for t in range(n_trials):
        target = EVAL_CATS[t % 16]
        foils = [str(c) for c in rng.choice(
            [c for c in EVAL_CATS if c != target], 3, replace=False)]
        trials.append({"trial_num": t, "target_category": target,
                       "target_img_filename": paths[target][rng.randint(4)],
                       "foil_categories": foils,
                       "foil_img_filenames": [paths[c][rng.randint(4)]
                                              for c in foils]})
    path = root / "eval_filtered_dev.json"
    path.write_text(json.dumps({"data": trials}))
    return path, paths


class Decoded:
    """A trial dataset's items, decoded once, with its ``data``."""

    def __init__(self, dataset, n=None):
        self.data = dataset.data[:n]
        self.items = [dataset[i] for i in range(len(self.data))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@contextlib.contextmanager
def trunk_path(model, path):
    """The trunk's forward for the eval: "kernels" (as built), "plain" (the
    kernels' plain versions on the card) or "f32" (the f32 conv path, or
    the ViT's plain blocks in f32)."""
    trunk = model.vision_encoder.model
    if path == "f32":
        if model.cfg.vision.vit_dino:
            trunk.forward = lambda x: trunk.forward_plain(x.float())
        else:
            trunk.forward = lambda x, train=False: trunk.forward_conv(
                x.float())
    try:
        if path == "plain":
            with plain_kernels():
                yield
        else:
            yield
    finally:
        trunk.__dict__.pop("forward", None)


@contextlib.contextmanager
def per_chunk(model, counters):
    """For each ``encode_image`` call (one per eval chunk): the batch, the
    launches of each counter in it (set to 0 before the run), the trunk's
    features (pooled or CLS) and the image embeddings."""
    calls, trunk_out = [], []
    for fn, attr in counters:
        setattr(fn, attr, 0)

    def keep(module, inputs, output):
        trunk_out.append(output["pooled"] if isinstance(output, dict)
                         else output)

    def encode_image(image, train=False):
        before = [getattr(fn, attr) for fn, attr in counters]
        out = type(model).encode_image(model, image, train)
        calls.append((image.shape[0],
                      [getattr(fn, attr) - b
                       for (fn, attr), b in zip(counters, before)],
                      trunk_out[-1].float(), out[0].float()))
        return out

    hook = model.vision_encoder.model.register_forward_hook(keep)
    model.encode_image = encode_image
    try:
        yield calls
    finally:
        del model.encode_image
        hook.remove()


def run_eval(model, dataset, mode, counters, path="kernels"):
    """run_forced_choice through ``path``: (records, per-chunk calls,
    seconds)."""
    with trunk_path(model, path), per_chunk(model, counters) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, records = run_forced_choice(model, dataset, mode,
                                       batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
    return records, calls, time.perf_counter() - t0


def gate_eval(what, kernel, plain, f32):
    """Kernel path against its plain versions: per-row cosine of the
    trunk's features >= SLICE_COS_TOL, equal decisions wherever the plain
    top-two gap exceeds EVAL_GAP and on >= EVAL_AGREE of all trials; the
    agreement with f32 and the embeddings' cosine printed (``fit_head``'s
    head scales the features' small spread up to clear decisions, and with
    it their differences)."""
    (k_rec, k_calls), (p_rec, p_calls), (f_rec, _) = kernel, plain, f32
    cos = min(float(row_cosines(k[2], p[2]).min())
              for k, p in zip(k_calls, p_calls))
    emb_cos = min(float(row_cosines(k[3], p[3]).min())
                  for k, p in zip(k_calls, p_calls))
    preds = [np.asarray([r["pred"] for r in rec])
             for rec in (k_rec, p_rec, f_rec)]
    lp = np.log([r["logits"] for r in p_rec])
    top2 = np.sort(lp, axis=1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    clear = gaps > EVAL_GAP
    same = preds[0] == preds[1]
    acc = [float(np.mean([r["correct"] for r in rec]))
           for rec in (k_rec, p_rec, f_rec)]
    log(f"  {what}: trunk features vs plain per-row cos min {cos:.7f} "
        f"(embeddings {emb_cos:.7f}); "
        f"decisions equal to plain on {int(same.sum())}/{same.size} trials "
        f"({int(same[clear].sum())}/{int(clear.sum())} with a top-two gap > "
        f"{EVAL_GAP}; median gap {float(np.median(gaps)):.4f}), to f32 on "
        f"{int((preds[0] == preds[2]).sum())}/"
        f"{same.size}; accuracy kernels {acc[0]:.4f}, plain {acc[1]:.4f}, "
        f"f32 {acc[2]:.4f}")
    if not (cos >= SLICE_COS_TOL and same[clear].all()
            and same.mean() >= EVAL_AGREE):
        raise AssertionError(f"{what}: eval gates failed (cos {cos:.7f}, "
                             f"{int(same.sum())}/{same.size} equal)")


def check_chunks(what, calls, want_of_batch):
    """The launches of each chunk against the plan for its batch."""
    got = [(b, n) for b, n, _, _ in calls]
    log(f"  {what} launches per chunk (B, counts): {got}")
    bad = [(b, n) for b, n in got if n != want_of_batch(b)]
    if bad:
        raise AssertionError(f"{what}: chunks {bad} against the plan")


def eval_resnext(what, model, datasets, card):
    """Image and text mode through the kernels, their plain versions and
    f32 on the same decoded trials: gates, launches per chunk, trials/s."""
    int8 = any(model.vision_encoder.model.int8_plan)
    for mode, (dataset, decoded) in datasets.items():
        runs = {}
        for path in ("kernels", "plain", "f32"):
            records, calls, _ = run_eval(model, decoded, mode,
                                         RESNEXT_COUNTERS, path)
            runs[path] = (records, calls)
        check_chunks(f"{what}, {mode} mode", runs["kernels"][1],
                     lambda b: PLAN_INT8 if int8 and b % 32 == 0
                     else PLAN_BF16)
        gate_eval(f"{what}, {mode} mode", runs["kernels"], runs["plain"],
                  runs["f32"])
        _, _, secs = run_eval(model, dataset, mode, RESNEXT_COUNTERS)
        _, _, secs_dec = run_eval(model, decoded, mode, RESNEXT_COUNTERS)
        log(f"  {what}, {mode} mode: {len(decoded)} trials in {secs:.3f} s "
            f"with PNG decoding ({len(decoded) / secs:.1f} trials/s), "
            f"{secs_dec:.3f} s on decoded trials "
            f"({len(decoded) / secs_dec:.1f} trials/s); {card}")


def write_reference_ckpt(model, root):
    """``model``'s weights (no amax buffers, the tied LM weight added) as a
    reference Lightning ``.ckpt`` with its hparams, the packaged
    ``vocab.json`` beside it. Returns the checkpoint's path."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if not k.endswith("_amax")}
    sd["language_model.output_layer.weight"] = \
        sd["text_encoder.embedding.weight"]  # tied, as the reference
    mc = model.cfg
    hparams = {"text_encoder": "embedding",
               "embedding_dim": mc.embedding_dim,
               "embedding_type": "flat", "normalize_features": True,
               "fix_temperature": True, "temperature": mc.temperature,
               "cnn_dino": True, "vit_dino": False, "tie": True,
               "bias": True}
    ckpt = root / "cvcl.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": hparams}, ckpt)
    (root / "vocab.json").write_bytes(PACKAGED_VOCAB.read_bytes())
    return ckpt


def phase_eval_and_api(published, vit_model, card):
    """9a: phase 5's weights through a reference-format checkpoint and
    load_model; 9b: forced choice with it and with phase 5's int8 model;
    9c: the ViT eval; 9d: the linear probe's features and a probe. The
    ResNeXt's and the ViT's heads are first fitted to the eval's
    categories (``fit_head``)."""
    rng = np.random.RandomState(9)
    int8_model = published[0].model
    frames, cats = eval_frames(rng, 4)
    vocab = Vocab.load(PACKAGED_VOCAB)
    fit_head(int8_model, frames, cats, vocab)
    fit_head(vit_model, frames, cats, vocab)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        log("  -- 9a the checkpoint round trip")
        ckpt = write_reference_ckpt(int8_model, root)
        api, prep = load_model(str(ckpt))
        loaded = api.model
        trunk = loaded.vision_encoder.model
        beside = json.loads((root / "vocab.json").read_text())
        log(f"  loaded {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB) "
            f"on {api.device}: trunk {trunk.dtype}, int8 "
            f"{trunk.int8_plan}, plan {trunk.fused_plan}; vocab "
            f"{len(api.vocab)} words, equal to the one beside it: "
            f"{api.vocab.word2idx == beside}")
        from PIL import Image
        images = np.stack([prep(Image.fromarray(f))
                           for f in eval_frames(rng, 1)[0][:8]])
        tokens, lens = api.tokenize(["ball", "a cat"])
        for fn, attr in RESNEXT_COUNTERS:
            setattr(fn, attr, 0)
        img = api.encode_image(images)
        txt = api.encode_text(tokens, lens)
        lpi, lpt = api(images, tokens, lens)
        torch.cuda.synchronize()
        counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
        want = (img @ txt.T) * loaded.logit_scale()
        err = float((lpi - want).abs().max())
        int8_api = CVCLModel(int8_model, api.vocab)
        same = int8_api.encode_image(images)  # B = 8: its bf16 plan
        log(f"  five calls: tokens {tuple(tokens.shape)}, image features "
            f"{tuple(img.shape)}, text features {tuple(txt.shape)}, logits "
            f"{tuple(lpi.shape)}; |logits - scale * img @ txt.T| max "
            f"{err:.2e}; launches K1, K2, K3a, K3b {counts} (2 forwards); "
            f"image features equal to phase 5's model's: "
            f"{bool(torch.equal(img, same))}")
        if not (err <= 1e-3 and torch.equal(lpt, lpi.T)
                and counts == [2 * n for n in PLAN_BF16]
                and torch.equal(img, same)
                and torch.isfinite(lpi).all()):
            raise AssertionError("9a: the five calls failed their checks")

        log("  -- 9b forced choice at full width, 257 + 257 trials")
        meta = load_metadata(write_eval_set(root, rng, frames, cats)[0])
        datasets = {}
        for mode, cls in (("image", EvalTrialDataset),
                          ("text", TextEvalTrialDataset)):
            dataset = cls(meta, api.vocab, eval_include_sos_eos=True)
            datasets[mode] = (dataset, Decoded(dataset))
        eval_resnext("loaded checkpoint (bf16 plan)", loaded, datasets, card)
        eval_resnext("phase 5's int8 model", int8_api.model, datasets,
                     card)

        log(f"  -- 9c the ViT eval, {VIT_EVAL_TRIALS} image-mode trials")
        vit_data = Decoded(datasets["image"][0], VIT_EVAL_TRIALS)
        runs = {path: run_eval(vit_model, vit_data, "image", VIT_COUNTERS,
                               path)[:2]
                for path in ("kernels", "plain", "f32")}
        check_chunks("ViT", runs["kernels"][1],
                     lambda b: [VIT_DEPTH, VIT_DEPTH])
        gate_eval("ViT, image mode", runs["kernels"], runs["plain"],
                  runs["f32"])

    log(f"  -- 9d the linear probe, {PROBE_FRAMES} frames")
    frames, labels = eval_frames(rng, PROBE_FRAMES // 16)
    for fn, attr in RESNEXT_COUNTERS:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    feats = extract_backbone_features(int8_model, frames)
    secs = time.perf_counter() - t0
    counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
    with plain_kernels():
        plain = extract_backbone_features(int8_model, frames)
    cos = float(row_cosines(torch.from_numpy(feats),
                            torch.from_numpy(plain)).min())
    chunks = -(-PROBE_FRAMES // 256)
    log(f"  backbone features {feats.shape} in {secs:.3f} s: launches K1, "
        f"K2, K3a, K3b {counts} ({chunks} chunks of 256); per-row cos vs "
        f"plain min {cos:.7f}")
    if counts != [chunks * n for n in PLAN_INT8] or not cos >= SLICE_COS_TOL:
        raise AssertionError(f"9d: launches {counts}, cos {cos:.7f}")
    train, test = half_split(labels, "first")
    params, metrics = train_linear_probe(feats[train], labels[train], 16,
                                         epochs=5)
    log(f"  probe on 16 classes, 5 epochs: train accuracy "
        f"{metrics['train_acc']:.4f}, held-out half "
        f"{probe_accuracy(params, feats[test], labels[test]):.4f}")
    if not math.isfinite(metrics["train_ce"]):
        raise AssertionError(f"9d: probe loss {metrics['train_ce']}")


# ----------------------------------------------------------------- phase 10

# the published recipe's flags (configs/_base.py:9-35) at the benchmark's
# batch, on synthetic data (10a, 10b) or a SAYCam-format directory (10c)
RECIPE_ARGV = [
    "--cnn_dino", "--frozen_bn", "running", "--trunk_int8", "0,0,1,1",
    "--text_encoder", "embedding", "--embedding_dim", "512",
    "--normalize_features", "--fix_temperature", "--temperature", "0.07",
    "--augment_frames", "--dropout_i", "0.5", "--optimizer", "AdamW",
    "--lr", "1e-4", "--weight_decay", "0.1", "--lr_scheduler",
    "--drop_last", "--optimize_unused", "--num_workers", "8",
    "--log_every_n_steps", "1"]
TRAIN_BATCH = BATCH
TRAIN_DEVICE = "cuda"
SYNTHETIC_SIZE = 512  # 4 steps an epoch
SAYCAM_TRAIN, SAYCAM_VAL, SAYCAM_TRIALS = 512, 128, 64
LOSS_PLAIN_RTOL = 1e-2   # 10a: train losses, kernels against plain
AMAX_RTOL = 1e-6         # 10b: amax after _recalibrate against the saved
RESUME_RTOL = 1e-5       # 10b: resumed third epoch against uninterrupted


def trainer_argv(root, exp, *extra):
    return [*RECIPE_ARGV, "--batch_size", str(TRAIN_BATCH),
            "--val_batch_size", str(TRAIN_BATCH), "--device", TRAIN_DEVICE,
            "--checkpoint_dir", str(root), "--exp_name", exp, *extra]


def synthetic_argv(root, exp, *extra):
    return trainer_argv(root, exp, "--dataset", "synthetic",
                        "--synthetic_size", str(SYNTHETIC_SIZE),
                        "--max_epochs", "2", *extra)


def logged(ckdir, key):
    return [r[key] for r in map(json.loads, (ckdir / "metrics.jsonl")
                                .read_text().splitlines()) if key in r]


def count_calls(trainer, calls):
    """Wrap the trainer's train and eval steps: each call appends (kind,
    batch, K1/K2/K3a/K3b launches in it). The counts are set to 0 here."""
    for fn, attr in RESNEXT_COUNTERS:
        setattr(fn, attr, 0)

    def wrap(kind, step):
        def counted(*args):
            before = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
            out = step(*args)
            calls.append((kind, int(args[-1]["text"].shape[0]),
                          [getattr(fn, attr) - b for (fn, attr), b
                           in zip(RESNEXT_COUNTERS, before)]))
            return out
        return counted

    trainer.train_step = wrap("train", trainer.train_step)
    trainer.eval_step = wrap("eval", trainer.eval_step)


def time_epochs(trainer, seconds, waits):
    """Record each train epoch's wall time (to the end of its device work)
    and its wait on the loader."""
    epoch_fn = trainer.train_epoch

    def timed(epoch):
        t0 = time.perf_counter()
        out = epoch_fn(epoch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        waits.append(trainer.loader_wait_s)
        return out
    trainer.train_epoch = timed


def check_files(ckdir):
    index = json.loads((ckdir / "index.json").read_text())
    names = ["last"] + [b["name"] for b in index["best"]]
    missing = [n for n in ("index.json", "config.json", "metrics.jsonl",
                           "vocab.json") if not (ckdir / n).exists()]
    missing += [n for n in names if not (ckdir / n / "state.pt").exists()]
    if missing or not any(n.startswith("epoch_") for n in names):
        raise AssertionError(f"{ckdir}: missing {missing}, index {index}")
    return names


def phase_trainer_synthetic(root, card, phase5_step_s):
    """10a: the published recipe through cli/train on synthetic data, the
    kernels against their plain versions; 10b: its resume."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    from multimodal_baby_tpu_torch.train.optimizer import get_learning_rate
    from multimodal_baby_tpu_torch.train.profiler import (
        StepTimer, device_memory_stats)

    log("  -- 10a the published recipe, 2 epochs of synthetic pairs")
    timer = StepTimer(warmup=2)
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer(synthetic_argv(root, "kernels"), step_timer=timer)
    calls, secs, waits = [], [], []
    count_calls(trainer, calls)
    time_epochs(trainer, secs, waits)
    t0 = time.perf_counter()
    trainer.fit()
    fit_s = time.perf_counter() - t0
    counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
    peak = device_memory_stats()[0]["peak_bytes_in_use"]
    per_step = [n for kind, _, n in calls if kind == "train"]
    per_val = [(b, n) for kind, b, n in calls if kind == "eval"]
    log(f"  launches K1, K2, K3a, K3b over the fit {counts}: per train "
        f"step {per_step}; per val batch (B, counts) {per_val}")
    if (len(per_step) != 2 * SYNTHETIC_SIZE // TRAIN_BATCH
            or any(n != PLAN_INT8 for n in per_step)
            or counts != [sum(c) for c in zip(*[n for _, _, n in calls])]):
        raise AssertionError(f"10a: launches per train step {per_step}, "
                             f"fit {counts}")
    ckdir = root / "kernels"
    losses = logged(ckdir, "train_loss")
    val = logged(ckdir, "val_loss")
    names = check_files(ckdir)
    with plain_kernels():
        plain = make_trainer(synthetic_argv(root, "plain"))
        plain.fit()
    plain_losses = logged(root / "plain", "train_loss")
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    log(f"  train losses {losses}, val {val}; plain versions "
        f"{plain_losses}: largest relative difference {diff:.3e} (gate "
        f"{LOSS_PLAIN_RTOL}); checkpoints {names}")
    if not (all(math.isfinite(v) for v in losses + val + plain_losses)
            and len(losses) == len(plain_losses) == len(per_step)
            and diff <= LOSS_PLAIN_RTOL):
        raise AssertionError(f"10a: losses {losses} against {plain_losses}")
    rep = timer.report(items_per_step=TRAIN_BATCH)
    log(f"  step (StepTimer, {rep['steps_timed']} steps after 2 warmup): "
        f"mean {rep['mean_s'] * 1e3:.3f} ms, p50 {rep['p50_s'] * 1e3:.3f} "
        f"ms, p90 {rep['p90_s'] * 1e3:.3f} ms, {rep['items_per_sec']:.1f} "
        f"pairs/s; phase 5's step {phase5_step_s * 1e3:.3f} ms "
        f"({TRAIN_BATCH / phase5_step_s:.1f} pairs/s); peak device memory "
        f"{peak / 2**30:.3f} GiB; per epoch {[round(t, 3) for t in secs]} s "
        f"of which waiting on the loader {[round(w, 4) for w in waits]} s; "
        f"fit {fit_s:.2f} s (validation and checkpoints included); {card}")

    log("  -- 10b resume from 'last' to a third epoch")
    saved = torch.load(ckdir / "last" / "state.pt",
                       map_location=TRAIN_DEVICE, weights_only=True)
    resumed = make_trainer(synthetic_argv(root, "kernels", "--resume_ckpt",
                                          "last", "--max_epochs", "3"))
    state = resumed.state
    now = resumed.model.state_dict()
    amax = [k for k in now if k.endswith("_amax")]
    amax_diff = max(float((now[k] - saved["model"][k]).abs()
                          / saved["model"][k].abs().clamp_min(1e-30))
                    for k in amax)
    weights = all(torch.equal(now[k], v) for k, v in saved["model"].items()
                  if k not in amax)
    opt, opt_saved = state.optimizer.state_dict(), saved["optimizer"]
    moments = (opt["param_groups"] == opt_saved["param_groups"] and all(
        torch.equal(v, opt_saved["state"][i][n])
        for i, st in opt["state"].items() for n, v in st.items()))
    same = {"weights": weights, "AdamW moments": moments,
            "LR": get_learning_rate(state.optimizer) == saved["lr"],
            "plateau": resumed.plateau.state_dict() == saved["plateau"],
            "generator": torch.equal(state.generator.get_state(),
                                     saved["generator"].cpu())}
    log(f"  start_epoch {resumed.start_epoch}, step {state.step}; equal to "
        f"the saved state bit for bit: {same}; {len(amax)} amax buffers "
        f"after _recalibrate within {amax_diff:.3e} relative of the saved "
        f"(gate {AMAX_RTOL})")
    if not (resumed.start_epoch == 2 and state.step == 8 and all(
            same.values()) and amax_diff <= AMAX_RTOL):
        raise AssertionError("10b: the resumed state differs")
    resumed.fit()
    full = make_trainer(synthetic_argv(root, "full", "--max_epochs", "3"))
    full.fit()
    third = logged(ckdir, "train_loss")[len(losses):]
    want = logged(root / "full", "train_loss")[len(losses):]
    diff = max(abs(a - b) / abs(b) for a, b in zip(third, want))
    log(f"  step {state.step} after the third epoch; its losses {third}, "
        f"uninterrupted {want}: largest relative difference {diff:.3e} "
        f"(gate {RESUME_RTOL})")
    if not (state.step == 12 and len(third) == len(want) == 4
            and diff <= RESUME_RTOL):
        raise AssertionError(f"10b: {third} against {want}")


def write_saycam_dir(root, rng):
    """A SAYCam-format directory: phase 9b's 64 PNG frames (16
    categories), SAYCAM_TRAIN utterances of packaged-vocab words with 2-4
    frames of their category each, SAYCAM_VAL of them in val.json,
    SAYCAM_TRIALS trials, and the packaged vocab."""
    root.mkdir()
    frames, cats = eval_frames(rng, 4)
    _, paths = write_eval_set(root, rng, frames, cats, SAYCAM_TRIALS)
    vocab = Vocab.load(PACKAGED_VOCAB)
    words = [w for w in vocab.word2idx if not w.startswith("<")]

    def entries(n):
        out = []
        for i in range(n):
            cat = EVAL_CATS[i % 16]
            k = rng.randint(2, 5)
            pick = rng.choice(4, k, replace=k > 4)
            out.append({"utterance": " ".join(
                [cat] + list(rng.choice(words, rng.randint(1, 4)))),
                "frame_filenames": [paths[cat][j] for j in pick]})
        return out

    for name, n in (("train", SAYCAM_TRAIN), ("val", SAYCAM_VAL)):
        (root / f"{name}.json").write_text(json.dumps({"data": entries(n)}))
    (root / "vocab.json").write_bytes(PACKAGED_VOCAB.read_bytes())


def phase_trainer_saycam(root, card):
    """10c: one epoch on a SAYCam-format directory, forced choice in the
    validation on the kernels, then load_model on what it wrote."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer

    log(f"  -- 10c a SAYCam-format directory: {SAYCAM_TRAIN} train, "
        f"{SAYCAM_VAL} val pairs, {SAYCAM_TRIALS} trials, PNG frames")
    data = root / "saycam_data"
    write_saycam_dir(data, np.random.RandomState(10))
    trainer = make_trainer(trainer_argv(
        root, "saycam", "--dataset", "saycam", "--data_dir", str(data),
        "--multiple_frames", "--eval_include_sos_eos", "--max_epochs", "1"))
    calls, secs, waits = [], [], []
    count_calls(trainer, calls)
    time_epochs(trainer, secs, waits)
    # the launches of each trunk call of the validation's forced choice
    import multimodal_baby_tpu_torch.train.trainer as trainer_module
    fc, active = [], []
    forced_choice = trainer_module.run_forced_choice
    encode = trainer.model.encode_image

    def run_counted(*args, **kwargs):
        active.append(True)
        try:
            return forced_choice(*args, **kwargs)
        finally:
            active.clear()

    def encode_image(image, train=False):
        before = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
        out = encode(image, train)
        if active:
            fc.append((image.shape[0], [
                getattr(fn, attr) - b
                for (fn, attr), b in zip(RESNEXT_COUNTERS, before)]))
        return out
    trainer.model.encode_image = encode_image
    trainer_module.run_forced_choice = run_counted
    try:
        val = trainer.fit()
    finally:
        trainer_module.run_forced_choice = forced_choice
        del trainer.model.encode_image
    pairs = SAYCAM_TRAIN // TRAIN_BATCH * TRAIN_BATCH
    per_step = [n for kind, _, n in calls if kind == "train"]
    log(f"  val loss {val['loss']:.5f}, forced-choice accuracy "
        f"{val['accuracy']:.4f}; launches per train step {per_step}, "
        f"per forced-choice chunk {fc}; the epoch {secs[0]:.3f} s: "
        f"{pairs / secs[0]:.1f} pairs/s with PNG decoding, "
        f"{waits[0]:.3f} s of it waiting on the loader; {card}")
    if not (per_step and all(n == PLAN_INT8 for n in per_step)
            and fc == [(4 * SAYCAM_TRIALS, PLAN_INT8)]
            and math.isfinite(val["loss"])):
        raise AssertionError(f"10c: launches {per_step}, chunks {fc}")
    ckdir = root / "saycam"
    check_files(ckdir)
    api, prep = load_model(str(ckdir), device=TRAIN_DEVICE)
    from PIL import Image
    rng = np.random.RandomState(11)
    images = np.stack([prep(Image.fromarray(f))
                       for f in eval_frames(rng, 1)[0][:8]])
    got = api.encode_image(images)
    want = CVCLModel(trainer.model, api.vocab).encode_image(images)
    accs, _ = run_forced_choice(api.model, trainer.data.eval_datasets["val"],
                                "image")
    log(f"  load_model({ckdir.name}/): image features at B = 8 equal to "
        f"the trainer's model's bit for bit: {torch.equal(got, want)}; "
        f"forced-choice accuracy {accs['total']:.4f} against the "
        f"validation's {val['accuracy']:.4f}")
    if not (torch.equal(got, want) and accs["total"] == val["accuracy"]):
        raise AssertionError("10c: the loaded checkpoint differs")


def phase_trainer(card, phase5_step_s, root):
    """10a-10c under ``root``, which phase 12 reads afterwards."""
    phase_trainer_synthetic(root, card, phase5_step_s)
    phase_trainer_saycam(root, card)


# ----------------------------------------------------------------- phase 11

# configs/saycam_joint.py on the published trunk (phase 10's flags), with the
# validation's text generation at the recipe's val_batch_size
JOINT_ARGV = ["--text_encoder", "lstm", "--sim", "mean", "--lambda_mm",
              "0.5", "--lambda_lm", "0.5", "--eval_textgen", "--beam_width",
              "3", "--decode_length", "25", "--val_batch_size", "16"]
TEXTGEN_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                "CIDEr", "SPICE")
CAM_TRIALS = 8       # 11c: the overlays of 8 trials, 32 maps
CAM_STEPS = 8        # 11c: grad_cam_captioning's steps on one frame
CE_ATOL = 1e-4       # 11e: per-token cross-entropy, K9 against the scan
HIDDEN_COS = 0.9999  # 11e: hidden states, per row


@contextlib.contextmanager
def recorded_textgen():
    """Yields (runs, decodes): each (scores, references, hypotheses) the
    trainer's validation gets from run_textgen_eval, and each
    decode_batch call's (batch, seconds to the end of its device work)."""
    import multimodal_baby_tpu_torch.train.trainer as trainer_module
    from multimodal_baby_tpu_torch.evaluation import textgen
    real_run, real_decode = (trainer_module.run_textgen_eval,
                             textgen.decode_batch)
    runs, decodes = [], []

    def run(*args, **kwargs):
        runs.append(real_run(*args, **kwargs))
        return runs[-1]

    def decode(model, batch, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_decode(model, batch, *args, **kwargs)
        torch.cuda.synchronize()
        decodes.append((len(batch["text"]), time.perf_counter() - t0))
        return out

    trainer_module.run_textgen_eval, textgen.decode_batch = run, decode
    try:
        yield runs, decodes
    finally:
        trainer_module.run_textgen_eval, textgen.decode_batch = (
            real_run, real_decode)


def map_cosines(a, b):
    """Per-map cosine of [N, H, W] maps; two all-zero maps agree."""
    a, b = a.flatten(1).double(), b.flatten(1).double()
    den = a.norm(dim=1) * b.norm(dim=1)
    both_zero = (a.abs().amax(1) == 0) & (b.abs().amax(1) == 0)
    return torch.where(both_zero, 1.0, (a * b).sum(1) / den.clamp_min(1e-300))


def phase_textgen_trainer(root, card):
    """11a: the joint recipe through cli/train with eval_textgen on a
    SAYCam-format directory; the validation again under plain_kernels()."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer

    log("  -- 11a the joint recipe (configs/saycam_joint.py) with "
        "eval_textgen, one epoch")
    data = root / "saycam_data"
    write_saycam_dir(data, np.random.RandomState(10))
    trainer = make_trainer(trainer_argv(
        root, "joint", "--dataset", "saycam", "--data_dir", str(data),
        "--multiple_frames", "--eval_include_sos_eos", "--max_epochs", "1",
        *JOINT_ARGV))
    calls = []
    count_calls(trainer, calls)
    with recorded_textgen() as (runs, decodes):
        t0 = time.perf_counter()
        val = trainer.fit()
        fit_s = time.perf_counter() - t0
        n_decodes = len(decodes)
        with plain_kernels():
            plain_val = trainer.validate("val")
    decodes = decodes[:n_decodes]
    per_step = [n for kind, _, n in calls if kind == "train"]
    scores = {k: val.get(k, float("nan")) for k in TEXTGEN_KEYS}
    hyps, plain_hyps = runs[0][2], runs[1][2]
    dec_s = sum(t for _, t in decodes)
    n_seq = sum(b for b, _ in decodes)
    log(f"  launches per train step {per_step}; val loss {val['loss']:.5f}, "
        f"forced-choice accuracy {val['accuracy']:.4f}; text generation "
        f"{scores}; {len(hyps)} hypotheses ({len(set(hyps))} distinct: the "
        f"unconditioned decode starts every row from SOS), e.g. "
        f"{hyps[0]!r}; under plain_kernels() equal token for token: "
        f"{hyps == plain_hyps} (scores {plain_val['CIDEr']:.6f} CIDEr)")
    log(f"  decode: {len(decodes)} validation batches of "
        f"{sorted({b for b, _ in decodes})} in {dec_s:.3f} s, "
        f"{dec_s / len(decodes) * 1e3:.1f} ms a batch, {n_seq / dec_s:.1f} "
        f"sequences/s (beam 3, 25 steps); the fit {fit_s:.2f} s; {card}")
    if not (per_step and all(n == PLAN_INT8 for n in per_step)
            and all(math.isfinite(v) for v in scores.values())
            and len(hyps) == SAYCAM_VAL and hyps == plain_hyps):
        raise AssertionError(f"11a: launches {per_step}, scores {scores}")
    return data


def captioning_model(published):
    """A captioning LSTM on phase 5's calibrated trunk (its weights and int8
    ranges; the head, the LSTM and the connector freshly seeded: phase 9's
    fitted head would scale the embeddings' bf16 differences up, 11c)."""
    cfg = recipe_cfg(0.0, 1.0)
    cfg.model.text = TextConfig(text_encoder="lstm", captioning=True)
    model = CVCL(cfg.model, torch.bfloat16, device="cuda",
                 generator=torch.Generator().manual_seed(11))
    trunk = {k: v for k, v in published[0].model.state_dict().items()
             if k.startswith("vision_encoder.model.")
             and not k.startswith("vision_encoder.model.fc.")}
    missing, unexpected = model.load_state_dict(trunk, strict=False)
    if unexpected or any(k.startswith("vision_encoder.") and
                         not k.startswith("vision_encoder.model.fc.")
                         for k in missing):
        raise AssertionError(f"11b: trunk keys {unexpected}, {missing}")
    return model


def phase_captioning(published, card):
    """11b: run_textgen_eval in captioning mode over phase 9b's frames;
    image features and decodes against plain_kernels()."""
    from multimodal_baby_tpu_torch.evaluation.textgen import (
        ids_to_sentence, run_textgen_eval)

    log("  -- 11b captioning text generation on phase 5's trunk, 64 frames "
        "at B = 64")
    model = captioning_model(published)
    frames, cats = eval_frames(np.random.RandomState(9), 4)
    vocab = Vocab.load(PACKAGED_VOCAB)
    n = len(frames)
    batch = {"text": np.zeros((n, MAX_LEN_UTTERANCE), np.int64),
             "text_len": np.ones((n,), np.int64),
             "raw": [EVAL_CATS[c] for c in cats], "image_u8": frames}
    run_textgen_eval(model, [batch], vocab, captioning=True)  # warm-up
    for fn, attr in RESNEXT_COUNTERS:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, _, hyps = run_textgen_eval(model, [batch], vocab,
                                       captioning=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
    x = normalize_image(torch.from_numpy(frames).cuda())
    runs = {}
    for path in ("kernels", "plain"):
        with trunk_path(model, path), torch.no_grad(), \
                per_chunk(model, RESNEXT_COUNTERS) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, _ = model.encode_image(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            seq, beam = model.beam_search_decode(n, 3, 25, 0.0, feats)
            torch.cuda.synchronize()
            runs[path] = (calls[0][2], calls[0][3], seq[:, 0], beam,
                          t1 - t0, time.perf_counter() - t1)
    (trunk, feats, seq, _, enc_s, dec_s), (p_trunk, p_feats, p_seq, p_beam,
                                           _, _) = runs["kernels"], \
        runs["plain"]
    # the gate reads the trunk's output: phase 9's fitted head scales the
    # features' small spread, and with it their differences, up
    cos = float(row_cosines(trunk, p_trunk).min())
    emb_cos = float(row_cosines(feats, p_feats).min())
    clear = (p_beam[:, 0] - p_beam[:, 1]) > EVAL_GAP
    same = (seq == p_seq).all(dim=1)
    log(f"  launches K1, K2, K3a, K3b {counts} (one batch); trunk features "
        f"vs plain per-row cos min {cos:.7f} (image features "
        f"{emb_cos:.7f}); sequences equal to plain on "
        f"{int(same.sum())}/{n} ({int(same[clear].sum())}/"
        f"{int(clear.sum())} with a top-two beam gap > {EVAL_GAP}); "
        f"{len(set(hyps))} distinct captions, e.g. {hyps[0]!r}; scores "
        f"against the category names {scores}")
    log(f"  run_textgen_eval: {n} sequences in {secs:.3f} s, {n / secs:.1f} "
        f"sequences/s (scoring included); encode {enc_s * 1e3:.2f} ms, "
        f"decode {dec_s * 1e3:.2f} ms: {n / (enc_s + dec_s):.1f} "
        f"sequences/s; {card}")
    if not (counts == PLAN_INT8 and cos >= SLICE_COS_TOL
            and bool(same[clear].all())
            and hyps == [ids_to_sentence(s, vocab) for s in seq.cpu()]
            and all(math.isfinite(v) for v in scores.values())):
        raise AssertionError(f"11b: launches {counts}, cos {cos:.7f}, "
                             f"{int(same.sum())}/{n} equal")
    return model, frames[0], seq[0, :CAM_STEPS].cpu()


def phase_grad_cam(root, published, captioning, card):
    """11c: cli/eval --dump_attention_maps on phase 9a's checkpoint; grad_cam
    and grad_cam_captioning against plain_kernels()."""
    from multimodal_baby_tpu_torch.analysis.attention_maps import (
        grad_cam, grad_cam_captioning)
    from multimodal_baby_tpu_torch.cli.eval import main as eval_main

    log(f"  -- 11c grad-CAM: cli/eval --dump_attention_maps {CAM_TRIALS} on "
        f"phase 9a's checkpoint")
    root.mkdir()
    ckpt = write_reference_ckpt(published[0].model, root)
    rng = np.random.RandomState(9)
    frames, cats = eval_frames(rng, 4)
    write_eval_set(root, rng, frames, cats, n_trials=2 * CAM_TRIALS)
    out = root / "results"
    t0 = time.perf_counter()
    eval_main(["--checkpoint", str(ckpt), "--data_dir", str(root),
               "--eval_type", "image", "--eval_include_sos_eos",
               "--dump_attention_maps", str(CAM_TRIALS), "--output_dir",
               str(out), "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    pngs = sorted((out / f"attention_maps_{ckpt.stem}").glob("*.png"))
    api, _ = load_model(str(ckpt), device="cuda")
    model = api.model
    dataset = EvalTrialDataset(load_metadata(root / "eval_filtered_dev.json"),
                               api.vocab, eval_include_sos_eos=True)
    items = [dataset[i] for i in range(CAM_TRIALS)]

    def cam_maps(path):
        """(maps [4 * CAM_TRIALS, 224, 224], launches per trial, seconds)
        of grad_cam on each trial's images against its label."""
        got, per_trial, secs = [], [], 0.0
        with trunk_path(model, path):
            for imgs, ids, ln, _ in items:
                k = imgs.shape[0]
                before = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got.append(torch.from_numpy(grad_cam(
                    model, normalize_image(torch.from_numpy(imgs).cuda()),
                    torch.from_numpy(ids).cuda().long()[None].expand(k, -1),
                    torch.full((k,), int(ln), device="cuda"))))
                torch.cuda.synchronize()
                secs += time.perf_counter() - t0
                per_trial.append([getattr(fn, attr) - b for (fn, attr), b
                                  in zip(RESNEXT_COUNTERS, before)])
        return torch.cat(got), per_trial, secs

    # Phase 9's fitted head maps each category's mean feature onto its
    # label, so a frame's embedding lies close to its own label's and the
    # gradient of their product (the part orthogonal to the embedding) is
    # small beside the embeddings' bf16 differences, which the head's gain
    # scales up (phase 9b: embeddings at cosine 0.9995 where the trunk's
    # features are at 0.999999). Its maps are printed; the gate takes them
    # with a seeded random head, where the gradient is well conditioned.
    fitted = {path: cam_maps(path) for path in ("kernels", "plain", "f32")}
    fc = model.vision_encoder.model.fc
    saved = {k: v.clone() for k, v in fc.state_dict().items()}
    gen = torch.Generator().manual_seed(15)
    bound_w = 1.0 / math.sqrt(fc.in_features)
    with torch.no_grad():
        for t in (fc.weight, fc.bias):
            t.copy_(torch.rand(t.shape, generator=gen) * 2 * bound_w
                    - bound_w)
    maps = {path: cam_maps(path) for path in ("kernels", "plain", "f32")}
    fc.load_state_dict(saved)
    per_trial, secs = maps["kernels"][1], maps["kernels"][2]
    cos = float(map_cosines(maps["kernels"][0], maps["plain"][0]).min())
    cos_f32 = float(map_cosines(maps["kernels"][0], maps["f32"][0]).min())
    fit_cos = float(map_cosines(fitted["kernels"][0],
                                fitted["plain"][0]).min())
    fit_f32 = float(map_cosines(fitted["kernels"][0],
                                fitted["f32"][0]).min())
    log(f"  {len(pngs)} overlays written ({cli_s:.2f} s for the CLI's "
        f"forced choice and maps); grad_cam on {CAM_TRIALS} trials (B = 4): "
        f"launches per trial {per_trial}; per-map cos vs plain min "
        f"{cos:.7f}, vs the f32 conv path min {cos_f32:.7f} (phase 9's "
        f"fitted head: {fit_cos:.7f} and {fit_f32:.7f}); "
        f"{CAM_TRIALS * 4 / secs:.1f} maps/s; {card}")
    if not (len(pngs) == 4 * CAM_TRIALS
            and all(n == PLAN_BF16 for n in per_trial + fitted["kernels"][1])
            and cos >= SLICE_COS_TOL
            and torch.isfinite(fitted["kernels"][0]).all()):
        raise AssertionError(f"11c: {len(pngs)} overlays, launches "
                             f"{per_trial}, cos {cos:.7f}")

    cap_model, frame, caption = captioning
    x = normalize_image(torch.from_numpy(frame).cuda())
    cams = {}
    for path in ("kernels", "plain"):
        with trunk_path(cap_model, path):
            cams[path] = torch.from_numpy(grad_cam_captioning(
                cap_model, x, caption, CAM_STEPS))
    k, p = cams["kernels"], cams["plain"]
    cos = map_cosines(k[1:], p[1:])
    log(f"  grad_cam_captioning on 11b's first frame and caption "
        f"{caption.tolist()}: {tuple(k.shape)} maps, step 0 zero "
        f"{bool((k[0] == 0).all())}, in [{float(k.min()):.3f}, "
        f"{float(k.max()):.3f}]; per-map cos vs plain min "
        f"{float(cos.min()):.7f}")
    if not (k.shape == (CAM_STEPS, *frame.shape[:2])
            and bool((k[0] == 0).all())
            and float(k.min()) >= 0 and float(k.max()) <= 1 + 1e-6
            and float(cos.min()) >= SLICE_COS_TOL):
        raise AssertionError(f"11c: captioning maps, cos {cos.tolist()}")
    return api


def phase_alignment(root, api, data, card):
    """11d: the alignment's feature sets over phase 9b's frames, one
    directory per category, and the leak audit's embeddings on 11a's
    SAYCam-format directory, each against plain_kernels()."""
    from PIL import Image
    from multimodal_baby_tpu_torch.analysis.duplicates import run_leak_audit
    from multimodal_baby_tpu_torch.analysis.embeddings import (
        category_feature_sets, write_alignment_csvs)
    from multimodal_baby_tpu_torch.cli.analyze import (
        frame_embedder, frame_loader, leak_audit_metadata)

    log("  -- 11d the alignment's feature sets and the leak audit")
    model = api.model
    frames_dir = root / "eval_frames"
    frames, cats = eval_frames(np.random.RandomState(9), 4)
    for i, (frame, c) in enumerate(zip(frames, cats)):
        d = frames_dir / EVAL_CATS[c]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(frame).save(d / f"{i}.png")
    sets = {}
    for path in ("kernels", "plain"):
        with trunk_path(model, path), \
                per_chunk(model, RESNEXT_COUNTERS) as calls:
            t0 = time.perf_counter()
            sets[path] = category_feature_sets(model, frames_dir, api.vocab)
            secs = time.perf_counter() - t0
        if path == "kernels":
            chunks = [(b, n) for b, n, _, _ in calls]
            align_s = secs
    cos = min(float(row_cosines(torch.from_numpy(sets["kernels"][k]),
                                torch.from_numpy(sets["plain"][k])).min())
              for k in ("all_image_features", "mean_image_features"))
    feats = sets["kernels"]
    _, _, (r, pval) = write_alignment_csvs(
        feats["mean_image_features"], feats["text_features"],
        feats["categories"], root / "alignment")
    log(f"  alignment: {feats['all_image_features'].shape[0]} frames of "
        f"{len(feats['categories'])} categories in {align_s:.3f} s with PNG "
        f"decoding; launches per chunk (B, counts) {chunks}; feature sets "
        f"vs plain per-row cos min {cos:.7f}; Pearson r {r:.4f} (p "
        f"{pval:.2e}); {card}")
    if not (cos >= SLICE_COS_TOL
            and all(n == PLAN_BF16 for _, n in chunks)
            and len(chunks) == len(feats["categories"])):
        raise AssertionError(f"11d: alignment cos {cos:.7f}, chunks {chunks}")

    train_md, eval_md = leak_audit_metadata(data, "eval_filtered_dev.json")
    embed = frame_embedder(model, frame_loader(data / "train_5fps"))
    with per_chunk(model, RESNEXT_COUNTERS) as calls:
        t0 = time.perf_counter()
        report = run_leak_audit(train_md, eval_md, embed, root / "dups")
        audit_s = time.perf_counter() - t0
    chunks = collections.Counter((b, tuple(n)) for b, n, _, _ in calls)
    # the gate reads the trunk's output, as phase 9's: the fitted head
    # scales the embeddings' bf16 differences up (11c)
    eval_files = [e["target_img_filename"] for e in eval_md]
    embs = {}
    for path in ("kernels", "plain"):
        with trunk_path(model, path), \
                per_chunk(model, RESNEXT_COUNTERS) as calls:
            embed(eval_files)
        embs[path] = calls[0][2:]
    cos = float(row_cosines(embs["kernels"][0], embs["plain"][0]).min())
    emb_cos = float(row_cosines(embs["kernels"][1], embs["plain"][1]).min())
    log(f"  leak audit: {report['n_pairs']} eval frames matched in "
        f"{audit_s:.3f} s, proportions over {report['proportions_over']}; "
        f"chunks (B, launches): count {dict(chunks)}; the eval frames' "
        f"trunk features vs plain per-row cos min {cos:.7f} (embeddings "
        f"{emb_cos:.7f})")
    if not (cos >= SLICE_COS_TOL and report["n_pairs"] == len(eval_md)
            and all(n == tuple(PLAN_BF16) for _, n in chunks)):
        raise AssertionError(f"11d: leak audit cos {cos:.7f}, {report}")


def phase_token_pass(joint, data, card):
    """11e: collect_token_data over the directory's utterances on phase
    7b's joint model, K9 (fused_lstm=True) against the plain scan."""
    from multimodal_baby_tpu_torch.analysis.processing import (
        collect_token_data, sentence_batches)

    log("  -- 11e the per-token pass on phase 7b's joint model, "
        "fused_lstm=True")
    model, state = joint
    model.load_state_dict(state)
    utts = [r["utterance"] for split in ("train", "val") for r in
            json.loads((data / f"{split}.json").read_text())["data"]]
    vocab = Vocab.load(PACKAGED_VOCAB)
    batches = list(sentence_batches(utts, vocab, batch_size=64,
                                    max_len=MAX_LEN_UTTERANCE))
    forwards = []
    lm_forward = model.lm_forward

    def counted(*args, **kwargs):
        forwards.append(lstm_fused.launches)
        out = lm_forward(*args, **kwargs)
        forwards[-1] = lstm_fused.launches - forwards[-1]
        return out

    runs = {}
    model.lm_forward = counted
    try:
        for fused in (True, False):
            model.text_encoder.fused_lstm = fused
            collect_token_data(model, batches[:1], vocab)  # warm-up
            forwards.clear()
            lstm_fused.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[fused] = collect_token_data(model, batches, vocab,
                                             collect_hidden=True)
            runs[fused]["seconds"] = time.perf_counter() - t0
            runs[fused]["k9"] = list(forwards)
    finally:
        del model.lm_forward
    got, want = runs[True], runs[False]
    n_tok = len(got["token_id"])
    ce_err = float(np.abs(got["ce_loss"] - want["ce_loss"]).max())
    cos = float(row_cosines(torch.from_numpy(got["hidden"]),
                            torch.from_numpy(want["hidden"])).min())
    log(f"  {len(utts)} utterances, {len(batches)} batches, {n_tok} tokens: "
        f"K9 launches per lm_forward {got['k9']} (plain scan "
        f"{want['k9']}); cross-entropy vs the plain scan max abs err "
        f"{ce_err:.2e} (mean {float(got['ce_loss'].mean()):.4f}); hidden "
        f"states per-row cos min {cos:.7f}; {n_tok / got['seconds']:.1f} "
        f"tokens/s with K9, {n_tok / want['seconds']:.1f} with the scan; "
        f"{card}")
    if not (got["k9"] == [1] * len(batches) and want["k9"] == [0] *
            len(batches) and np.array_equal(got["token_id"],
                                            want["token_id"])
            and ce_err <= CE_ATOL and cos >= HIDDEN_COS):
        raise AssertionError(f"11e: K9 {got['k9']}, ce err {ce_err}, cos "
                             f"{cos}")


def phase_analyses(published, joint, card):
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = phase_textgen_trainer(root, card)
        captioning = phase_captioning(published, card)
        api = phase_grad_cam(root / "cam", published, captioning, card)
        phase_alignment(root, api, data, card)
        phase_token_pass(joint, data, card)
        log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 12

JPEG_FRAMES = 1024       # 12a, 12c: bench.py::ensure_jpeg_dataset's set
DECODE_BATCH = 128       # 12a: one decode_batch_checked call
EXACT_JPEG_MEAN = 2.0    # 12a: exact decode vs PIL bilinear, mean abs u8
                         # (tests/test_native_pipeline.py:47-53)


def real_io_module():
    """scripts/real_io_torch.py, imported from the checkout."""
    import importlib.util
    path = Path(__file__).resolve().parent / "scripts" / "real_io_torch.py"
    spec = importlib.util.spec_from_file_location("real_io_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def frames_per_s(fn, paths, reps=1):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(paths)
    return reps * len(paths) / (time.perf_counter() - t0)


def pil_frame(path, size=224):
    """The loader's PIL path (``load_image_uint8`` without the library):
    decode, bicubic resize when needed."""
    from PIL import Image
    with Image.open(path) as src:
        img = src.convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, np.uint8)


def phase_decoder(root, card):
    """12a: which decoder runs; the native decoder's batch against its
    frame-by-frame decode and its exact mode against PIL; frames/s of the
    native batch, native per frame and PIL per frame, JPEG and PNG."""
    import os
    from PIL import Image
    from multimodal_baby_tpu_torch.data import native

    decoder = ("native" if native.available()
               else f"pil ({native.build_error()})")
    log(f"  -- 12a decoder: {decoder}; os.cpu_count() {os.cpu_count()}")
    meta = real_io_module().write_jpeg_dataset(root / "jpegs", JPEG_FRAMES)
    jpegs = [r["frame_filename"] for r in load_metadata(meta)]
    pngs = sorted(str(p) for p in (root / "saycam_data").glob("*.png"))
    rates = {}
    for kind, paths in (("JPEG 256 px", jpegs), ("PNG 224 px", pngs)):
        rates[kind] = {"PIL per frame": frames_per_s(
            lambda ps: [pil_frame(p) for p in ps], paths)}
        if native.available():
            rates[kind]["native per frame"] = frames_per_s(
                lambda ps: [native.decode_image(p) for p in ps], paths)
            rates[kind]["native batch"] = frames_per_s(
                lambda ps: [native.decode_batch_checked(
                    ps[i:i + DECODE_BATCH])
                    for i in range(0, len(ps), DECODE_BATCH)], paths)
    if native.available():
        batch, ok = native.decode_batch_checked(jpegs[:DECODE_BATCH])
        same = all(np.array_equal(batch[i], native.decode_image(p))
                   for i, p in enumerate(jpegs[:DECODE_BATCH]))
        exact = np.stack([native.decode_image(p, fast=False)
                          for p in jpegs[:32]]).astype(int)
        pil = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
            (224, 224), Image.BILINEAR)) for p in jpegs[:32]]).astype(int)
        png = all(np.array_equal(
            native.decode_image(p, Image.open(p).size[0], fast=False),
            np.asarray(Image.open(p).convert("RGB"))) for p in pngs[:16])
        err = float(np.abs(exact - pil).mean())
        log(f"  one decode_batch_checked call over {DECODE_BATCH} JPEGs "
            f"equal to decode_image frame by frame: {same}; mask all ones: "
            f"{bool(ok.all())}; the exact decode against PIL's bilinear "
            f"resize: mean abs {err:.4f} (gate {EXACT_JPEG_MEAN}); the PNGs "
            f"equal to PIL's: {png}")
        if not (same and ok.all() and err < EXACT_JPEG_MEAN and png):
            raise AssertionError("12a: the native decoder's checks failed")
    else:
        log("  the native decoder is not built here: its checks and rates "
            "are not measured; the loader decodes with PIL")
    for kind, r in rates.items():
        log(f"  {kind}: " + ", ".join(f"{k} {v:.1f} frames/s"
                                      for k, v in r.items())
            + f"; {card}")
    return decoder, jpegs


def jpeg_copy(src, dst):
    """The SAYCam-format directory ``src`` with its PNG frames as JPEGs
    at quality 90 (same names, .jpg) and its metadata pointing at them."""
    from PIL import Image
    dst.mkdir()
    for p in src.glob("*.png"):
        with Image.open(p) as img:
            img.convert("RGB").save(dst / f"{p.stem}.jpg", quality=90)
    for p in src.glob("*.json"):
        text = p.read_text()
        if p.name != "vocab.json":
            text = text.replace(str(src), str(dst)).replace(".png", ".jpg")
        (dst / p.name).write_text(text)
    return dst


def fit_recorded(root, exp, data, sync):
    """One epoch of 10c's flags on ``data`` through cli/train, with the
    loader in ``sync`` mode: (trainer, launches per train step, the
    epoch's seconds and loader wait, every (host, device) batch)."""
    import functools
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    from multimodal_baby_tpu_torch.data.loader import DataLoader
    import multimodal_baby_tpu_torch.train.trainer as trainer_module

    trainer = make_trainer(trainer_argv(
        root, exp, "--dataset", "saycam", "--data_dir", str(data),
        "--multiple_frames", "--eval_include_sos_eos", "--max_epochs", "1"))
    calls, secs, waits, pairs = [], [], [], []
    count_calls(trainer, calls)
    time_epochs(trainer, secs, waits)
    to_device = trainer_module.device_batch

    def recorded(batch, device, staging=None):
        out = to_device(batch, device, staging)
        pairs.append((batch, out))
        return out

    trainer_module.device_batch = recorded
    if sync:
        trainer_module.DataLoader = functools.partial(DataLoader, sync=True)
    try:
        trainer.fit()
    finally:
        trainer_module.device_batch = to_device
        trainer_module.DataLoader = DataLoader
    per_step = [n for kind, _, n in calls if kind == "train"]
    return trainer, per_step, secs[0], waits[0], pairs


def phase_trainer_real_frames(root, card):
    """12b: 10c's recipe for one epoch on its PNG directory and on a JPEG
    copy; launches per step, every device batch against its host batch,
    the losses against the same epoch with the loader in sync mode."""
    log("  -- 12b the trainer on 10c's PNG frames and on their JPEG copy")
    dirs = {"png": root / "saycam_data",
            "jpeg": jpeg_copy(root / "saycam_data", root / "saycam_jpeg")}
    for kind, data in dirs.items():
        _, per_step, secs, wait, pairs = fit_recorded(
            root, f"real_{kind}", data, sync=False)
        _, _, sync_secs, _, _ = fit_recorded(root, f"real_{kind}_sync",
                                             data, sync=True)
        bad = [i for i, (host, dev) in enumerate(pairs)
               if set(dev) != {"image_u8", "text", "text_len"} or not all(
                   torch.equal(dev[k].cpu(), torch.from_numpy(
                       np.asarray(host[k], np.int64) if k != "image_u8"
                       else host[k])) for k in dev)]
        losses = logged(root / f"real_{kind}", "train_loss")
        sync_losses = logged(root / f"real_{kind}_sync", "train_loss")
        pairs_n = SAYCAM_TRAIN // TRAIN_BATCH * TRAIN_BATCH
        log(f"  {kind}: launches per train step {per_step}; "
            f"{len(pairs) - len(bad)}/{len(pairs)} device batches equal to "
            f"their host batches; train losses {losses}, with the loader in "
            f"sync mode {sync_losses}: equal bit for bit "
            f"{losses == sync_losses}; the epoch {secs:.3f} s, "
            f"{pairs_n / secs:.1f} pairs/s, {wait:.3f} s "
            f"({100 * wait / secs:.1f}%) waiting on the loader (sync mode: "
            f"{pairs_n / sync_secs:.1f} pairs/s); {card}")
        if not (per_step and all(n == PLAN_INT8 for n in per_step)
                and not bad and len(losses) == len(per_step)
                and losses == sync_losses
                and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"12b {kind}: launches {per_step}, batches "
                                 f"{bad} differ, losses {losses} against "
                                 f"{sync_losses}")


def phase_real_io(root, card):
    """12c: scripts/real_io_torch.py at B = 128."""
    log(f"  -- 12c scripts/real_io_torch.py: {JPEG_FRAMES} JPEGs, B = "
        f"{TRAIN_BATCH}, 4 loader threads")
    res = real_io_module().run(root / "real_io", JPEG_FRAMES, TRAIN_BATCH,
                               TRAIN_DEVICE)
    h2d = res.get("h2d_mb_s", {"pageable": math.nan, "pinned": math.nan})
    log(f"  decoder {res['decoder']}; {res['pairs_per_s']:.1f} pairs/s over "
        f"{len(res['loss'])} timed steps ({res['seconds']:.3f} s: "
        f"{res['wait_s']:.3f} s waiting on the loader, "
        f"{res['stage_s']:.3f} s staging the copies); launches per step "
        f"{res['launches']}; H2D of one batch's frames "
        f"({TRAIN_BATCH * 224 * 224 * 3 / 1e6:.1f} MB): pageable "
        f"{h2d['pageable']:.1f} MB/s, pinned {h2d['pinned']:.1f} MB/s; "
        f"{card}")
    if not (all(n == PLAN_INT8 for n in res["launches"])
            and all(math.isfinite(v) for v in res["loss"])):
        raise AssertionError(f"12c: launches {res['launches']}, losses "
                             f"{res['loss']}")


def phase_forced_choice_jpeg(root, published, card):
    """12d: phase 9b's image-mode trials from JPEG files of its frames,
    through phase 9a's checkpoint (bf16 plan), decoding as it goes and on
    the same frames decoded first."""
    log(f"  -- 12d forced choice with decoding, {EVAL_TRIALS} image-mode "
        "trials from JPEG frames")
    root.mkdir()
    rng = np.random.RandomState(9)  # phase 9's frames and trials
    frames, cats = eval_frames(rng, 4)
    eval_frames(rng, 1)
    api, _ = load_model(str(write_reference_ckpt(published[0].model, root)),
                        device=TRAIN_DEVICE)
    meta = load_metadata(write_eval_set(root, rng, frames, cats,
                                        ext=".jpg")[0])
    dataset = EvalTrialDataset(meta, api.vocab, eval_include_sos_eos=True)
    decoded = Decoded(dataset)
    run_eval(api.model, decoded, "image", RESNEXT_COUNTERS)  # warm
    want, _, dec_s = run_eval(api.model, decoded, "image", RESNEXT_COUNTERS)
    got, calls, secs = run_eval(api.model, dataset, "image",
                                RESNEXT_COUNTERS)
    same = [a["pred"] == b["pred"] for a, b in zip(got, want)]
    log(f"  {len(got)} trials in {secs:.3f} s decoding JPEGs "
        f"({len(got) / secs:.1f} trials/s), "
        f"{dec_s:.3f} s on decoded frames ({len(got) / dec_s:.1f} "
        f"trials/s); decisions equal to those on the decoded frames: "
        f"{sum(same)}/{len(same)}; {card}")
    check_chunks("12d", calls, lambda b: PLAN_BF16)
    if not (len(same) == len(meta) and all(same)):
        raise AssertionError("12d: decisions differ with decoding")


def phase_host_chain(root, card):
    """12e: CheckpointRegistry over phase 10's checkpoint root, cli/analyze
    summaries, descriptives (and figures where matplotlib is installed) on
    10c's outputs and directory, and cli/runner on a configs/ grid."""
    import importlib
    import importlib.util
    from PIL import Image
    from multimodal_baby_tpu_torch.analysis.checkpoints import (
        CheckpointRegistry)
    from multimodal_baby_tpu_torch.cli import analyze, runner
    from multimodal_baby_tpu_torch.cli import eval as cli_eval

    log("  -- 12e the checkpoint registry, the analysis CLI and the runner")
    found = CheckpointRegistry(root).scan()
    best = min((e for e in found.values()
                if e["best_val_loss"] is not None),
               key=lambda e: e["best_val_loss"])
    name = next(k for k, e in found.items() if e is best)
    loaded = CheckpointRegistry(root).load(name, device=TRAIN_DEVICE)
    direct, prep = load_model(best["path"], device=TRAIN_DEVICE)
    images = np.stack([prep(Image.fromarray(f)) for f in
                       eval_frames(np.random.RandomState(11), 1)[0][:8]])
    equal = torch.equal(loaded.encode_image(images),
                        direct.encode_image(images))
    log(f"  registry: {len(found)} experiments {sorted(found)}; best "
        f"{name!r} (val loss {best['best_val_loss']:.5f}); its load's image "
        f"features equal to from_checkpoint_dir's bit for bit: {equal}")
    if not equal:
        raise AssertionError("12e: the registry's model differs")

    data, results = root / "saycam_data", root / "results"
    t0 = time.perf_counter()
    quiet = contextlib.redirect_stdout(io.StringIO())  # the CLIs' tables
    with quiet:
        cli_eval.main(["--checkpoint", str(root / "saycam"), "--data_dir",
                       str(data), "--eval_include_sos_eos", "--output_dir",
                       str(root / "predictions"), "--device", TRAIN_DEVICE])
    preds = root / "predictions" / "saycam_image_dev_saycam_predictions.json"
    dst = (results / "saycam" / "embedding_frozen_pretrained_seed_0_image_"
           "saycam_test_eval_predictions.json")
    dst.parent.mkdir(parents=True)
    dst.write_bytes(preds.read_bytes())
    with quiet:
        tables = analyze.main(["summaries", "--results_dir", str(results)])
        desc = analyze.main(["descriptives", "--data_dir", str(data),
                             "--out_csv", str(results / "descriptives.csv")])
    bounds = tables["saycam-bounds-summary"]
    total = desc[desc["split"] == "TOTAL"].iloc[0]
    ran = ["summaries", "descriptives"]
    if importlib.util.find_spec("matplotlib") is not None:
        with quiet:
            analyze.main(["figures", "--summary_csv", str(
                results / "summary" / "saycam-bounds-summary.csv"),
                "--out_dir", str(results / "figures")])
        ran.append("figures")
    note = "all three" if len(ran) == 3 else "figures: no matplotlib"
    log(f"  cli/analyze ran {ran} ({note}) in "
        f"{time.perf_counter() - t0:.2f} s, cli/eval included: "
        f"saycam-bounds-summary {len(bounds)} rows (accuracy "
        f"{bounds['correct'].mean():.4f}); descriptives TOTAL "
        f"{int(total['n_utterances'])} utterances, {int(total['n_tokens'])} "
        f"tokens, {int(total['n_frames'])} frames")
    if not (len(bounds) == SAYCAM_TRIALS and int(total["n_utterances"])
            == SAYCAM_TRAIN + SAYCAM_VAL):
        raise AssertionError("12e: the analysis CLI's tables")

    grid = importlib.import_module("configs.saycam_contrastive")
    scripts = root / "sweep"
    with quiet:  # the job lines
        jobs = runner.main(["--config", "configs.saycam_contrastive",
                            "--dry_run"])
        runner.main(["--config", "configs.saycam_contrastive",
                     "--emit_scripts", str(scripts), "--", "--data_dir",
                     str(data), "--max_epochs", "1", "--batch_size",
                     str(TRAIN_BATCH), "--val_batch_size", str(TRAIN_BATCH),
                     "--frozen_bn", "running", "--trunk_int8", "0,0,1,1",
                     "--checkpoint_dir", str(root / "sweep_runs"),
                     "--device", TRAIN_DEVICE])
    script = sorted(scripts.glob("*.sh"))[0]
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", str(script)], capture_output=True,
                          text=True, timeout=600, check=False)
    job_s = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
    log(f"  cli/runner: --dry_run lists {len(jobs)} jobs, the grid expands "
        f"to {len(runner.expand_grids(grid.grids))}; --emit_scripts wrote "
        f"{len(list(scripts.glob('*.sh')))} scripts; {script.name} exited "
        f"{proc.returncode} in {job_s:.1f} s: {tail}")
    if not (len(jobs) == len(runner.expand_grids(grid.grids))
            and proc.returncode == 0):
        raise AssertionError(f"12e: runner jobs {len(jobs)}, the job "
                             f"exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")


def phase_host_input(root, published, card):
    t0 = time.perf_counter()
    decoder, _ = phase_decoder(root, card)
    phase_trainer_real_frames(root, card)
    phase_real_io(root, card)
    phase_forced_choice_jpeg(root / "fc_jpeg", published, card)
    phase_host_chain(root, card)
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s; decoder: "
        f"{decoder}")


# ----------------------------------------------------------------- phase 13

# 22 Labeled-S-style categories of the packaged vocabulary, and the four the
# ETL drops from the trials (etl.py: EXCLUDED_EVAL_CATEGORIES)
LABELED_S_CATS = ("ball", "basket", "car", "cat", "chair", "computer",
                  "crib", "door", "floor", "foot", "ground", "kitchen",
                  "paper", "puzzle", "road", "room", "sand", "stairs",
                  "table", "toy", "tv", "window")
EXCLUDED_CATS = ("carseat", "couch", "greenery", "plushanimal")
SPEAKERS = ("M", "Mom", "mother", "S", "Child")  # the last two are dropped


def can_write_mp4(root) -> bool:
    """Whether cv2 is installed and writes an .mp4 it reads back."""
    try:
        import cv2
    except ImportError:
        return False
    path = Path(root) / ".probe.mp4"
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 5,
                          (64, 48))
    for _ in range(3):
        out.write(np.zeros((48, 64, 3), np.uint8))
    out.release()
    cap = cv2.VideoCapture(str(path))
    ok = cap.read()[0]
    cap.release()
    path.unlink(missing_ok=True)
    return bool(ok)


def write_raw_saycam(root, rng, words, n_transcripts, n_rows,
                     categories=LABELED_S_CATS + EXCLUDED_CATS,
                     per_category=6, size=224, video=True,
                     video_seconds=None, max_gap=8):
    """A raw SAYCam-format tree under ``root`` from ``rng``:
    ``transcripts/`` (CSVs with Time, Speaker, Utterance, Video Name:
    ``n_rows`` rows each, 1 to ``max_gap`` - 1 s apart, in the mixed time
    forms, with bracketed asides, inaudible marks, two-sentence turns and
    speakers the ETL drops), ``labeled_s/<category>/`` (``per_category``
    PNG frames of ``size`` px each) and, with ``video``, ``videos/`` (an
    .mp4 per transcript at 5 fps, 320 x 240, as long as the transcript or
    ``video_seconds``). Returns the three directories (videos None
    without ``video``)."""
    root = Path(root)
    tdir, ldir = root / "transcripts", root / "labeled_s"
    tdir.mkdir(parents=True)
    words = list(words)
    last = {}
    for t in range(n_transcripts):
        name = f"S_{t:03d}"
        sec, rows = rng.randint(0, 3), []
        for _ in range(n_rows):
            mm, ss = divmod(sec, 60)
            form = rng.randint(6)
            time_ = (f"{mm}.{ss:02d}" if form == 0
                     else f"{mm}:{ss:02d}-{mm}:{ss + 1:02d}" if form == 1
                     and ss < 59 else f"{mm}:{ss:02d}")
            utt = " ".join(rng.choice(words, rng.randint(1, 7)))
            extra = rng.randint(8)
            if extra == 0:
                utt += ". " + " ".join(rng.choice(words, rng.randint(1, 4)))
            elif extra == 1:
                utt += " [laughs]"
            elif extra == 2:
                utt = "[inaudible] " + utt
            rows.append((time_, SPEAKERS[rng.randint(len(SPEAKERS))], utt,
                         f"{name}.avi"))
            sec += rng.randint(1, max_gap)
        last[name] = sec
        with open(tdir / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Time", "Speaker", "Utterance", "Video Name"])
            w.writerows(rows)
    from PIL import Image
    for ci, cat in enumerate(categories):
        d = ldir / cat
        d.mkdir(parents=True)
        base = rng.randint(0, 256, (size // 8, size // 8, 3)).astype(
            np.int16).repeat(8, 0).repeat(8, 1)
        for i in range(per_category):
            img = np.clip(base + rng.randint(-24, 25, base.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"{cat}_{i}.png")
    vdir = None
    if video:
        import cv2
        vdir = root / "videos"
        vdir.mkdir()
        for name, sec in last.items():
            out = cv2.VideoWriter(str(vdir / f"{name}.mp4"),
                                  cv2.VideoWriter_fourcc(*"mp4v"), 5,
                                  (320, 240))
            cells = rng.randint(0, 256, (30, 40, 3)).astype(np.int16)
            for k in range(5 * (video_seconds or sec + 8)):
                frame = np.roll(cells, k, axis=1).repeat(8, 0).repeat(8, 1)
                out.write(frame.astype(np.uint8))
            out.release()
    return tdir, ldir, vdir


ETL_TRANSCRIPTS, ETL_ROWS, ETL_MAX_GAP = 3, 150, 3  # ~2,000 frame rows
ETL_PER_CATEGORY = 6
ETL_CATEGORIES = LABELED_S_CATS + EXCLUDED_CATS  # 22 in the trials
COCO_IMAGES, COCO_CAPTIONS, COCO_BATCH = 256, 5, 64
DIST_RTOL = 1e-6     # 13d: distributed step against the one-device step


def available(module: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(module) is not None


def tree_stamps(root):
    return {str(p.relative_to(root)): p.stat().st_mtime_ns
            for p in Path(root).rglob("*") if p.is_file()}


@contextlib.contextmanager
def decode_once():
    """Each eval frame decoded once: ``load_image_uint8`` memoized by
    path inside (the trial datasets read every frame once per trial)."""
    import functools
    from multimodal_baby_tpu_torch.data import datasets
    load = datasets.load_image_uint8
    datasets.load_image_uint8 = functools.lru_cache(maxsize=None)(load)
    try:
        yield
    finally:
        datasets.load_image_uint8 = load


def write_missing_frames(data, rng):
    """Without cv2's video step: a JPEG for every frame the metadata
    names, at 320 x 240 cropped as the ETL crops (the transcript step's
    file names, frames drawn here)."""
    from PIL import Image
    names = {f for split in ("train", "val", "test") for e in json.loads(
        (data / f"{split}.json").read_text())["data"]
        for f in e["frame_filenames"]}
    cells = rng.randint(0, 256, (28, 28, 3)).astype(np.uint8)
    for i, name in enumerate(sorted(names)):
        img = np.roll(cells, i, axis=1).repeat(8, 0).repeat(8, 1)
        Path(name).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(name, quality=90)
    return len(names)


def phase_etl(root, card):
    """13a: a raw SAYCam tree through prepare_data (twice), one epoch of
    the published recipe on its output, forced choice on its trials."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    from multimodal_baby_tpu_torch.data.datasets import (
        EvalTrialDataset, load_metadata)

    mods = {m: available(m) for m in ("cv2", "pandas", "spacy")}
    video = mods["cv2"] and can_write_mp4(root)
    log(f"  -- 13a the ETL to a trained epoch; installed {mods}, cv2 "
        f"writes and reads .mp4: {video}")
    if not mods["cv2"]:
        log("  cv2 is missing: no video step; the frames the transcripts "
            "name are written by this phase (the video step is held by "
            "the CPU tests)")
    # the categories four times over beside the vocab's 100 most frequent
    # words: every category passes the vocab's count threshold of 3
    vocab = Vocab.load(PACKAGED_VOCAB)
    words = [w for w in vocab.word2idx if not w.startswith("<")][:100]
    words += [c for c in ETL_CATEGORIES if c not in EXCLUDED_CATS] * 4
    rng = np.random.RandomState(13)
    t0 = time.perf_counter()
    tdir, ldir, vdir = write_raw_saycam(
        root / "raw", rng, words, ETL_TRANSCRIPTS, ETL_ROWS,
        categories=ETL_CATEGORIES, per_category=ETL_PER_CATEGORY,
        video=video, max_gap=ETL_MAX_GAP)
    raw_s = time.perf_counter() - t0
    data = root / "etl_data"
    argv = trainer_argv(root, "etl", "--dataset", "saycam", "--data_dir",
                        str(data), "--multiple_frames", "--max_epochs", "1",
                        "--eval_include_sos_eos",
                        "--transcript_dir", str(tdir), "--labeled_s_dir",
                        str(ldir), *(("--video_dir", str(vdir)) if vdir
                                     else ()))
    t0 = time.perf_counter()
    make_trainer([*argv, "--prepare_data_only"])
    etl_s = time.perf_counter() - t0
    stamps = tree_stamps(data)
    t0 = time.perf_counter()
    make_trainer([*argv, "--prepare_data_only"])
    again_s = time.perf_counter() - t0
    rewritten = [f for f, t in tree_stamps(data).items()
                 if stamps.get(f) != t]
    import pandas as pd
    rows = sum(len(pd.read_csv(f)) for f in
               (data / "preprocessed_transcripts_5fps").glob("*.csv"))
    splits = {s: len(load_metadata(data / f"{s}.json"))
              for s in ("train", "val", "test")}
    extracted = len(list((data / "train_5fps").glob("*.jpg"))) \
        if (data / "train_5fps").exists() else 0
    trials = {s: len(load_metadata(data / f"eval_{s}.json"))
              for s in ("dev", "test")}
    log(f"  raw tree {raw_s:.2f} s; prepare_data {etl_s:.2f} s: {rows} "
        f"frame rows, utterances {splits}, {extracted} frames extracted, "
        f"trials {trials}, vocab {len(Vocab.load(data / 'vocab.json'))}; "
        f"the second run {again_s:.3f} s rewrote {len(rewritten)} files")
    n_trials = 100 * len(set(ETL_CATEGORIES) - set(EXCLUDED_CATS))
    if rewritten or not (1500 <= rows <= 3000 and splits["train"]
                         >= 2 * TRAIN_BATCH and trials["dev"] == n_trials
                         and (extracted > 0) == video):
        raise AssertionError(f"13a: rewritten {rewritten[:3]}, rows {rows}, "
                             f"{splits}, {trials}, {extracted} frames")
    if not video:
        log(f"  wrote {write_missing_frames(data, rng)} frames")

    trainer = make_trainer(argv)
    calls, secs, waits = [], [], []
    count_calls(trainer, calls)
    time_epochs(trainer, secs, waits)
    val = trainer.fit()
    per_step = [n for kind, _, n in calls if kind == "train"]
    pairs = len(per_step) * TRAIN_BATCH
    log(f"  one epoch: launches per train step {per_step}, val loss "
        f"{val['loss']:.5f}; {secs[0]:.3f} s, {pairs / secs[0]:.1f} pairs/s, "
        f"{waits[0] / secs[0]:.1%} of it waiting on the loader; {card}")
    if not (per_step and all(n == PLAN_INT8 for n in per_step)
            and math.isfinite(val["loss"])):
        raise AssertionError(f"13a: launches {per_step}, val {val}")

    # the head fitted to the dev frames' categories: clear decisions
    from PIL import Image
    cats = sorted(d.name for d in (data / "eval" / "dev").iterdir()
                  if d.name not in EXCLUDED_CATS)
    dev = [(i, np.asarray(Image.open(f).convert("RGB")))
           for i, c in enumerate(cats)
           for f in sorted((data / "eval" / "dev" / c).iterdir())]
    model = trainer.model
    fit_head(model, np.stack([f for _, f in dev]),
             np.asarray([i for i, _ in dev]), trainer.data.vocab, cats)
    dataset = EvalTrialDataset(load_metadata(data / "eval_dev.json"),
                               trainer.data.vocab, eval_include_sos_eos=True)
    with decode_once():
        run_eval(model, Decoded(dataset, 4), "image", RESNEXT_COUNTERS)
        k_rec, k_calls, k_s = run_eval(model, dataset, "image",
                                       RESNEXT_COUNTERS)
        p_rec, _, p_s = run_eval(model, dataset, "image", RESNEXT_COUNTERS,
                                 "plain")
    preds = [np.asarray([r["pred"] for r in rec]) for rec in (k_rec, p_rec)]
    lp = np.log([r["logits"] for r in p_rec])
    top2 = np.sort(lp, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > EVAL_GAP
    same = preds[0] == preds[1]
    chunks = sorted({(b, tuple(n)) for b, n, _, _ in k_calls})
    log(f"  forced choice on eval_dev.json: {len(k_rec)} trials, accuracy "
        f"{np.mean([r['correct'] for r in k_rec]):.4f}; decisions equal to "
        f"plain on {int(same.sum())}/{same.size} "
        f"({int(same[clear].sum())}/{int(clear.sum())} with a top-two gap "
        f"> {EVAL_GAP}); launches per chunk {chunks}; "
        f"{len(k_rec) / k_s:.1f} trials/s (each frame decoded once), plain "
        f"versions {len(k_rec) / p_s:.1f}")
    if not (len(k_rec) == n_trials and same[clear].all()
            and clear.mean() >= 0.5
            and all(n == tuple(PLAN_INT8) for b, n in chunks
                    if b % Q_CHECK_BATCH == 0)):
        raise AssertionError(f"13a: forced choice {int(same.sum())} equal, "
                             f"chunks {chunks}")


def karpathy_json(root, rng, words, n=COCO_IMAGES, captions=COCO_CAPTIONS):
    """A Karpathy-format dataset_coco.json under ``root``: ``n`` 224 px
    JPEGs (train2014/ and val2014/), ``captions`` captions each over
    ``words``, split 3/4 train and restval, 1/8 val, 1/8 test."""
    from PIL import Image
    images = []
    for i in range(n):
        sub = "train2014" if i % 2 == 0 else "val2014"
        (root / sub).mkdir(parents=True, exist_ok=True)
        fname = f"COCO_{sub}_{i:012d}.jpg"
        cells = rng.randint(0, 256, (28, 28, 3)).astype(np.uint8)
        Image.fromarray(cells.repeat(8, 0).repeat(8, 1)).save(
            root / sub / fname, quality=90)
        split = ("val" if i % 8 == 1 else "test" if i % 8 == 3
                 else "restval" if i % 8 == 5 else "train")
        images.append({"filename": fname, "filepath": sub, "split": split,
                       "imgid": i, "sentences": [
                           {"tokens": list(rng.choice(words,
                                                      rng.randint(5, 12))),
                            "sentid": i * captions + j}
                           for j in range(captions)]})
    (root / "dataset_coco.json").write_text(json.dumps({"images": images}))


def phase_coco(root, card):
    """13b: prepare_coco, COCOCaptionsDataset and the captioning recipe
    through cli/train; a text-generation batch against plain."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    from multimodal_baby_tpu_torch.data.loader import DataLoader

    log(f"  -- 13b COCO: {COCO_IMAGES} images x {COCO_CAPTIONS} captions, "
        f"the captioning recipe at B = {COCO_BATCH}")
    data = root / "coco"
    vocab = Vocab.load(PACKAGED_VOCAB)
    words = [w for w in vocab.word2idx if not w.startswith("<")][:300]
    karpathy_json(data, np.random.RandomState(14), words)
    argv = [*RECIPE_ARGV, "--text_encoder", "lstm", "--captioning",
            "--lambda_mm", "0", "--lambda_lm", "1", "--dataset", "coco",
            "--data_dir", str(data), "--batch_size", str(COCO_BATCH),
            "--val_batch_size", str(COCO_BATCH), "--device", TRAIN_DEVICE,
            "--checkpoint_dir", str(root), "--exp_name", "coco",
            "--max_epochs", "1"]
    t0 = time.perf_counter()
    make_trainer([*argv, "--prepare_data_only"])
    prep_s = time.perf_counter() - t0
    trainer = make_trainer(argv)
    sizes = {k: len(v) for k, v in trainer.data.datasets.items()}
    calls, secs, waits = [], [], []
    count_calls(trainer, calls)
    time_epochs(trainer, secs, waits)
    val = trainer.fit()
    per_step = [n for kind, _, n in calls if kind == "train"]
    log(f"  prepare_coco {prep_s:.3f} s: vocab {trainer.data.vocab_size}, "
        f"splits {sizes}; launches per train step {per_step}; val ce "
        f"{val.get('ce_loss', float('nan')):.5f}; epoch {secs[0]:.3f} s")
    if not (per_step and all(n == PLAN_INT8 for n in per_step)
            and math.isfinite(val["loss"])):
        raise AssertionError(f"13b: launches {per_step}, val {val}")

    model = trainer.model
    batch = next(iter(DataLoader(trainer.data.datasets["val"], COCO_BATCH,
                                 shuffle=False, sync=True)))
    n = len(batch["text"])
    x = normalize_image(torch.from_numpy(batch["image_u8"]).cuda())
    runs = {}
    for path in ("kernels", "plain"):
        for fn, attr in RESNEXT_COUNTERS:
            setattr(fn, attr, 0)
        with trunk_path(model, path), torch.no_grad():
            feats, _ = model.encode_image(x)
            seq, beam = model.beam_search_decode(n, 3, 25, 0.0, feats)
        runs[path] = (seq[:, 0], beam, [getattr(fn, attr)
                                        for fn, attr in RESNEXT_COUNTERS])
    (seq, _, counts), (p_seq, p_beam, _) = runs["kernels"], runs["plain"]
    clear = (p_beam[:, 0] - p_beam[:, 1]) > EVAL_GAP
    same = (seq == p_seq).all(dim=1)
    log(f"  text generation on {n} val images: launches {counts}; decodes "
        f"equal to plain on {int(same.sum())}/{n} "
        f"({int(same[clear].sum())}/{int(clear.sum())} with a top-two beam "
        f"gap > {EVAL_GAP}); {card}")
    want = PLAN_INT8 if n % Q_CHECK_BATCH == 0 else PLAN_BF16
    if not (counts == want and bool(same[clear].all())):
        raise AssertionError(f"13b: launches {counts}, {int(same.sum())} "
                             "equal")


def save_dino(path, trunk_state):
    """A DINO-style checkpoint: the trunk under teacher/module.backbone.,
    beside a projection head and the epoch."""
    inner = {f"module.backbone.{k}": v.detach().cpu()
             for k, v in trunk_state.items()}
    inner["module.head.last_layer.weight_g"] = torch.ones(65536, 1)
    torch.save({"teacher": inner, "epoch": 100}, path)


def phase_backbones(root, published, card):
    """13c: local DINO checkpoints of seeded trunks loaded through
    api/backbones; features bit for bit those of the written model."""
    from multimodal_baby_tpu_torch.api.backbones import load_backbone

    log("  -- 13c backbones from local checkpoints, features at B = "
        f"{BATCH}")
    state, _, batch = published
    src = state.model
    vit_cfg, vit_src, _ = build_vit_slice()
    for name, cfg, model_a, counters, want in (
            ("dino_sfp_resnext50", src.cfg, src, RESNEXT_COUNTERS,
             PLAN_INT8),
            ("dino_sfp_vitb14", vit_cfg.model, vit_src, VIT_COUNTERS,
             [VIT_DEPTH, VIT_DEPTH])):
        trunk_a = model_a.vision_encoder.model
        keep = {k: v for k, v in trunk_a.state_dict().items()
                if not k.startswith(("fc.", "head."))
                and not k.endswith("_amax")}
        path = root / f"{name}.pth"
        save_dino(path, keep)
        model_b = CVCL(cfg, torch.bfloat16, device="cuda",
                       generator=torch.Generator().manual_seed(77))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch = load_backbone(model_b, name, str(path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        trunk_b = model_b.vision_encoder.model
        head = "head" if cfg.vision.vit_dino else "fc"
        getattr(trunk_b, head).load_state_dict(
            getattr(trunk_a, head).state_dict())
        if any(getattr(trunk_b, "int8_plan", ())):
            calibrate_trunk(model_a, batch)
            calibrate_trunk(model_b, batch)
        x = augment_batch(batch["image_u8"], augment=False,
                          dtype=torch.bfloat16)
        feats = []
        for model in (model_a, model_b):
            for fn, attr in counters:
                setattr(fn, attr, 0)
            with torch.no_grad():
                feats.append(model.encode_image(x)[0])
            counts = [getattr(fn, attr) for fn, attr in counters]
            if counts != want:
                raise AssertionError(f"13c {name}: launches {counts}")
        equal = torch.equal(feats[0], feats[1])
        log(f"  {name} ({arch}, {path.stat().st_size / 2**20:.1f} MiB): "
            f"loaded in {load_s:.3f} s; launches {want} a forward; "
            f"features equal to the written model's bit for bit: {equal}")
        if not equal:
            raise AssertionError(f"13c {name}: features differ")
        del model_b
    del vit_src
    log(f"  {card}")


def phase_distributed(root, published, phase5_step_s, card):
    """13d: the published recipe's train step through the distributed
    path (an nccl group of one, mesh (1, 1)) against the one-device step,
    in both negatives modes."""
    import torch.distributed as dist
    from multimodal_baby_tpu_torch.parallel.mesh import create_mesh

    log("  -- 13d the distributed step at world 1 (nccl, mesh 1,1)")
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh((1, 1))
        batch = published[2]
        for global_negatives in (True, False):
            models = []
            for on_mesh in (True, False):
                cfg, model, _ = build_resnext_slice(MIXED, None)
                calibrate_trunk(model, batch)
                cfg.parallel.global_batch_negatives = global_negatives
                cfg.parallel.mesh_shape = (1, 1)
                m = mesh if on_mesh else None
                state = init_train_state(model, cfg, m)
                models.append((model, state, make_train_step(model, cfg, m)))
            out = []
            for model, state, step in models:
                for fn, attr in RESNEXT_COUNTERS:
                    setattr(fn, attr, 0)
                metrics = [step(state, batch) for _ in range(2)]
                counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
                out.append(([float(mm["loss"]) for mm in metrics], counts,
                            {k: v.detach().clone() for k, v in
                             model.named_parameters() if v.requires_grad}))
            (d_loss, d_counts, d_heads), (p_loss, p_counts, p_heads) = out
            bitwise = d_loss == p_loss and all(
                torch.equal(v, p_heads[k]) for k, v in d_heads.items())
            rel = max(max(abs(a - b) / abs(b) for a, b in zip(d_loss,
                                                              p_loss)),
                      max(float((v - p_heads[k]).abs().max()
                                / p_heads[k].abs().max().clamp_min(1e-30))
                          for k, v in d_heads.items()))
            mode = "global" if global_negatives else "per-shard"
            log(f"  {mode} negatives: losses {d_loss} against one device's "
                f"{p_loss}; updated heads and losses equal bit for bit: "
                f"{bitwise} (largest relative difference {rel:.3e}, gate "
                f"{DIST_RTOL}); launches over 2 steps {d_counts} against "
                f"{p_counts}")
            if not (rel <= DIST_RTOL and d_counts == p_counts
                    == [2 * n for n in PLAN_INT8]):
                raise AssertionError(f"13d {mode}: {d_loss} vs {p_loss}")
        # the two steps in turns (distributed, one device, one device,
        # distributed), from their states after the checks
        times = {0: [], 1: []}
        for i in (0, 1, 1, 0):
            _, state, step = models[i]
            times[i].append(time_steps(state, step, batch,
                                       ("13d distributed (1, 1)",
                                        "13d one device")[i]))
        d_s, p_s = (float(np.mean(times[i])) for i in (0, 1))
        log(f"  distributed step {d_s * 1e3:.3f} ms, one device "
            f"{p_s * 1e3:.3f} ms (means of 2 turns of {TIMED_STEPS}); "
            f"phase 5's {phase5_step_s * 1e3:.3f} ms; {card}")
    finally:
        dist.destroy_process_group()


def phase_etl_coco_backbones_distributed(root, published, phase5_step_s,
                                         card):
    t0 = time.perf_counter()
    phase_etl(root, card)
    phase_coco(root, card)
    phase_backbones(root, published, card)
    phase_distributed(root, published, phase5_step_s, card)
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 14

# (e): stem -> (stem, stem_cpad, split_stem); "split" feeds the 4x4 stem
# the augment's space-to-depth layout
STEM_CONFIGS = {"conv7": ("conv7", False, False),
                "s2d": ("s2d", False, False),
                "split": ("conv7", False, True),
                "cpad": ("conv7", True, False),
                "s2d+cpad": ("s2d", True, False)}
STEM_PROFILED = 10   # stem calls under the profiler, per configuration
WRAPPER_BLOCK = ("layer1.0", 56, 64, 128, 256, 1, True)  # (g), at B = 32
VIT_ARGV = [  # bench.py's ViT flagship through cli/train (phase 4's model)
    "--vit_dino", "--text_encoder", "transformer", "--pos_embed_type",
    "learned", "--embedding_dim", "512", "--normalize_features",
    "--fix_temperature", "--temperature", "0.07", "--augment_frames",
    "--optimizer", "AdamW", "--lr", "1e-4", "--weight_decay", "0.1",
    "--drop_last", "--num_workers", "8", "--log_every_n_steps", "1"]
MODES_SYNTHETIC = 256  # (h): 2 train steps an epoch at B = 128


def set_stem(model, stem, cpad, split):
    """Switch a live model's stem and the train step's input layout (a
    train step made afterwards reads ``model.kernels.split_stem``)."""
    trunk = model.vision_encoder.model
    trunk.stem_mode, trunk.stem_cpad = stem, cpad
    model.kernels = dataclasses.replace(model.kernels, stem=stem,
                                        stem_cpad=cpad, split_stem=split)


def stem_ms(trunk, x):
    """The stem's device time a call (torch.profiler, the sum over its
    kernels), None where the profiler saw no device time; x NHWC."""
    from torch.profiler import ProfilerActivity, profile
    xn = x.contiguous().permute(0, 3, 1, 2)
    for _ in range(2):
        trunk.stem(xn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEM_PROFILED):
            trunk.stem(xn)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / STEM_PROFILED / 1e3 if us else None


def phase_stems(published):
    """14e: the published recipe (phase 5's model, calibrated) with each
    stem of STEM_CONFIGS: pooled features per row against the default stem
    (cosine >= SLICE_COS_TOL), the stem's time (profiler and events), one
    train step's launches (the published plan's [4, 1, 2, 1]), then the
    train steps in turns."""
    model, batch = published[0].model, published[2]
    trunk = model.vision_encoder.model
    cfg = flagship_cfg(vit=False, trunk_int8=MIXED)
    # an optimizer state of its own: the earlier phases train the same
    # model through other states
    state = init_train_state(model, cfg)
    runs, pooled = {}, {}
    for name, (stem, cpad, split) in STEM_CONFIGS.items():
        set_stem(model, stem, cpad, split)
        with torch.no_grad():
            x = augment_batch(batch["image_u8"], augment=False,
                              dtype=torch.bfloat16, s2d=split)
            pooled[name] = trunk(x)["pooled"]
            x_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16,
                                  s2d=split)
            prof_ms = stem_ms(trunk, x_aug)
            ev_ms = time_ms(lambda: trunk.stem(
                x_aug.contiguous().permute(0, 3, 1, 2)), 10)
        cos = float(row_cosines(pooled[name], pooled["conv7"]).min())
        step = make_train_step(model, cfg)
        for fn, attr in RESNEXT_COUNTERS:
            setattr(fn, attr, 0)
        loss = float(step(state, batch)["loss"])
        torch.cuda.synchronize()
        counts = [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]
        log(f"  stem {name}: input {tuple(x.shape)}, pooled per-row cosine "
            f"min {cos:.7f} to conv7 (gate >= {SLICE_COS_TOL}); stem "
            f"{'not measured' if prof_ms is None else f'{prof_ms:.4f}'} ms "
            f"(profiler), {ev_ms:.4f} ms (events); one train step: loss "
            f"{loss:.5f}, launches K1, K2, K3a, K3b {counts}")
        if not (cos >= SLICE_COS_TOL and counts == PLAN_INT8
                and math.isfinite(loss)):
            raise AssertionError(f"14e {name}: cosine {cos:.7f}, launches "
                                 f"{counts}, loss {loss}")
        runs[name] = (stem, cpad, split, step)
    times = collections.defaultdict(list)
    for name in list(STEM_CONFIGS) + list(STEM_CONFIGS)[::-1]:
        stem, cpad, split, step = runs[name]
        set_stem(model, stem, cpad, split)
        step(state, batch)  # untimed: the switch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    for name, ms in times.items():
        log(f"  published train step B={BATCH} in turns, stem {name}: "
            f"{' / '.join(f'{t:.3f}' for t in ms)} ms (mean "
            f"{sum(ms) / len(ms):.3f})")
    set_stem(model, "conv7", False, False)


def phase_augment_forms(batch):
    """14f: the augment's per-channel form (csplit) against the default
    under the same draws: max error <= one bf16 ulp of the output's range;
    the time of each form, and of the split stem's space-to-depth form."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    u8 = batch["image_u8"]
    draws = sample_augment(u8.shape[0], tuple(u8.shape[1:3]), gen, "cuda")
    with torch.no_grad():
        forms = {"default": {}, "csplit": {"csplit": True},
                 "s2d": {"s2d": True}}
        size = u8.shape[1]  # 224: the frames' own size
        out = {k: apply_augment(u8, draws, size, torch.bfloat16, **kw)
               for k, kw in forms.items()}
        ms = {k: time_ms(lambda kw=kw: apply_augment(
            u8, draws, size, torch.bfloat16, **kw), 10)
            for k, kw in forms.items()}
    ulp = float(out["default"].float().abs().max()) * 2 ** -7
    err = float((out["csplit"].float() - out["default"].float()).abs().max())
    s2d_err = float((out["s2d"].float() - space_to_depth(
        out["default"]).float()).abs().max())
    log(f"  augment B={BATCH}, bf16: csplit against default max error "
        f"{err:.4g} (gate <= one bf16 ulp of the range, {ulp:.4g}); s2d "
        f"against space_to_depth(default) {s2d_err:.4g}; ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    if not (err <= ulp and s2d_err <= ulp):
        raise AssertionError(f"14f: csplit error {err}, s2d error {s2d_err}"
                             f" > {ulp}")


def phase_bottleneck_diff():
    """14g: fused_bottleneck_diff at layer 1's head block (B = 32): the
    forward is K1's bit for bit, the gradients of x and of every folded
    weight per-tensor cosine >= COS_TOL to plain autograd through
    bottleneck_reference; the forward and backward timed against plain
    autograd's."""
    name, H, cin, width, cout, stride, ds = WRAPPER_BLOCK
    gen = torch.Generator().manual_seed(140)
    x, fw = random_block(gen, H, cin, width, cout, stride, ds, CHECK_BATCH * 4)
    leaves = [x.requires_grad_()] + [w.requires_grad_() for w in fw.values()]
    before = fused_bottleneck.launches
    y = fused_bottleneck_diff(x, fw, stride)
    torch.cuda.synchronize()
    launched = fused_bottleneck.launches - before
    with torch.no_grad():
        same = torch.equal(y, fused_bottleneck(x, fw, stride))
    g = torch.randn(y.shape, generator=gen).to("cuda", y.dtype)
    got = torch.autograd.grad(y, leaves, g)
    want = torch.autograd.grad(bottleneck_reference(x, fw, stride=stride),
                               leaves, g)
    cos = {n: cosine(a, b) for n, a, b in zip(["x", *fw], got, want)}

    def run(fn):
        return lambda: torch.autograd.grad(fn(x, fw, stride), leaves, g)
    t_k = time_ms(run(fused_bottleneck_diff), 5)
    t_p = time_ms(run(lambda x_, fw_, s: bottleneck_reference(
        x_, fw_, stride=s)), 5)
    log(f"  fused_bottleneck_diff at {name} (B = {x.shape[0]}): {launched} "
        f"K1 launch, forward equal to fused_bottleneck bit for bit: {same}; "
        f"gradient cosines to plain autograd min {min(cos.values()):.7f} "
        f"({', '.join(f'{k} {v:.7f}' for k, v in cos.items())}); forward + "
        f"backward {t_k:.3f} ms, plain autograd {t_p:.3f} ms")
    if not (same and launched == 1 and min(cos.values()) >= COS_TOL):
        raise AssertionError(f"14g: equal {same}, launches {launched}, "
                             f"cosines {cos}")


def fit_counted(argv, counters, prepare=lambda trainer: None):
    """Build the trainer of ``argv`` through cli/train, ``prepare`` it, fit
    it, and return (trainer, launches of ``counters`` in each train
    step)."""
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    trainer = make_trainer(argv)
    prepare(trainer)
    per_step = []
    step = trainer.train_step

    def counted(*args):
        before = [getattr(fn, attr) for fn, attr in counters]
        out = step(*args)
        per_step.append([getattr(fn, attr) - b for (fn, attr), b
                         in zip(counters, before)])
        return out
    trainer.train_step = counted
    trainer.fit()
    return trainer, per_step


def phase_cli_modes(root):
    """14h: cli/train with the new flags, one epoch of synthetic pairs at
    B = 128: the ViT flagship with --vit_int8 1 --vit_lnfold 1 (per train
    step 12 K8b launches and no other ViT kernel), then the published
    recipe with --split_stem 1 (per train step the plan's [4, 1, 2, 1],
    the trunk fed the space-to-depth layout in training and validation)."""
    common = ["--batch_size", str(BATCH), "--val_batch_size", str(BATCH),
              "--device", "cuda", "--checkpoint_dir", str(root),
              "--dataset", "synthetic", "--synthetic_size",
              str(MODES_SYNTHETIC), "--max_epochs", "1"]
    vit_counters = [(fn, "launches") for fn in VIT_KERNELS.values()]
    t0 = time.perf_counter()
    trainer, per_step = fit_counted(
        VIT_ARGV + common + ["--exp_name", "vit_modes", "--vit_int8", "1",
                             "--vit_lnfold", "1"], vit_counters)
    want = [VIT_DEPTH if k == "K8b" else 0 for k in VIT_KERNELS]
    losses = logged(root / "vit_modes", "train_loss")
    log(f"  ViT --vit_int8 1 --vit_lnfold 1: {trainer.model.kernels.vit}; "
        f"launches {list(VIT_KERNELS)} per train step {per_step}; train "
        f"losses {losses} ({time.perf_counter() - t0:.1f} s)")
    if not (per_step and all(n == want for n in per_step)
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"14h ViT: launches {per_step}, losses {losses}")

    t0 = time.perf_counter()
    seen = []

    def spy_stem(trainer):
        trunk = trainer.model.vision_encoder.model
        real = trunk._stem_from_s2d
        trunk._stem_from_s2d = lambda xs: seen.append(xs.shape[1]) or real(xs)

    trainer, per_step = fit_counted(
        RECIPE_ARGV + common + ["--exp_name", "split_stem", "--split_stem",
                                "1"], RESNEXT_COUNTERS, spy_stem)
    losses = logged(root / "split_stem", "train_loss")
    log(f"  published recipe --split_stem 1: launches K1, K2, K3a, K3b per "
        f"train step {per_step}; 4x4 stem calls {len(seen)} on "
        f"{sorted(set(seen))} channels; train losses {losses} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (per_step and all(n == PLAN_INT8 for n in per_step)
            and len(seen) > len(per_step) and set(seen) == {12}
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"14h split stem: launches {per_step}, stem "
                             f"inputs {seen}, losses {losses}")


def phase_opt_in_modes(root, published):
    t0 = time.perf_counter()
    phase_stems(published)
    phase_augment_forms(published[2])
    phase_bottleneck_diff()
    phase_cli_modes(root)
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 15

# CLIP at the published widths (the config.json of openai/clip-vit-large-
# patch14 and clip-vit-base-patch16: quick_gelu, LayerNorm eps 1e-5, 224
# px, 77 positions, vocab 49408), with random weights from a seed
CLIP_SPECS = {
    "ViT-L/14": {"projection_dim": 768,
                 "vision": dict(hidden_size=1024, intermediate_size=4096,
                                num_hidden_layers=24, num_attention_heads=16,
                                patch_size=14),
                 "text": dict(hidden_size=768, intermediate_size=3072,
                              num_hidden_layers=12, num_attention_heads=12)},
    "ViT-B/16": {"projection_dim": 512,
                 "vision": dict(hidden_size=768, intermediate_size=3072,
                                num_hidden_layers=12, num_attention_heads=12,
                                patch_size=16),
                 "text": dict(hidden_size=512, intermediate_size=2048,
                              num_hidden_layers=12, num_attention_heads=8)},
}
CLIP_IMAGE = 224
CLIP_TRIALS = 64          # 15a: four batches of 16 trials, B = 64 images
CLIP_BATCH = 16           # run_clip_forced_choice's default
CLIP_GAP = 0.05           # 15a: decisions equal where the f32 gap exceeds it
CLIP_PER_CATEGORY = 4     # 15b: frames of a category's own texture (and
                          # one of the next category's, which it drops)
CLIP_TIMED = 3            # 15a: timed runs of the forced choice
CLIP_FIT_SPREAD = 0.5     # the fitted projections' targets: top-two gap 0.2
# the batches the main path gives K5 and K6: 16 trials of 4 images; one
# filter chunk of a category (here 5 frames; 64 at most)
CLIP_KERNEL_BATCHES = {"ViT-L/14": (CLIP_BATCH * 4,),
                       "ViT-B/16": (CLIP_PER_CATEGORY + 1, 64)}
CLIP_SPECIALS = {"<|startoftext|>": 49406, "<|endoftext|>": 49407}


def clip_config_json(spec):
    """A CLIPModel config.json in the published files' form (old-style
    eos_token_id 2: the text tower pools at the row's largest id)."""
    common = dict(hidden_act="quick_gelu", layer_norm_eps=1e-5,
                  initializer_range=0.02, initializer_factor=1.0)
    return {"architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": spec["projection_dim"],
            "logit_scale_init_value": 2.6592,
            "text_config": {**common, **spec["text"], "vocab_size": 49408,
                            "max_position_embeddings": 77,
                            "bos_token_id": 0, "eos_token_id": 2,
                            "pad_token_id": 1},
            "vision_config": {**common, **spec["vision"],
                              "image_size": CLIP_IMAGE, "num_channels": 3}}


def clip_vocab(words):
    """A byte-level vocabulary (the 256 byte symbols, each also with
    ``</w>``), merges that build each of ``words`` whole, left to right,
    and the two special tokens at the published ids."""
    from multimodal_baby_tpu_torch.data.clip_tokenizer import (
        bytes_to_unicode)
    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(base + [b + "</w>" for b in base])}
    merges = []
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges.append(pair)
                vocab[pair[0] + pair[1]] = len(vocab)
            parts = [pair[0] + pair[1]] + parts[2:]
    return {**vocab, **CLIP_SPECIALS}, merges


def random_clip_state(config, seed):
    """A CLIPModel state dict (numpy f32, transformers' names) drawn on the
    card as transformers initializes CLIP, with LayerNorm scales 1 + 0.1 N
    and biases 0.1 N."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {}

    def put(name, shape, std, mean=0.0):
        state[name] = (torch.randn(shape, generator=gen, device="cuda") * std
                       + mean).cpu().numpy()

    for tower in ("text", "vision"):
        cfg = config[f"{tower}_config"]
        C, F_, L = (cfg["hidden_size"], cfg["intermediate_size"],
                    cfg["num_hidden_layers"])
        pre = f"{tower}_model"
        if tower == "text":
            put(f"{pre}.embeddings.token_embedding.weight",
                (cfg["vocab_size"], C), 0.02)
            put(f"{pre}.embeddings.position_embedding.weight",
                (cfg["max_position_embeddings"], C), 0.02)
            norms = ["final_layer_norm"]
        else:
            p = cfg["patch_size"]
            put(f"{pre}.embeddings.class_embedding", (C,), C ** -0.5)
            put(f"{pre}.embeddings.patch_embedding.weight", (C, 3, p, p),
                0.02)
            put(f"{pre}.embeddings.position_embedding.weight",
                ((CLIP_IMAGE // p) ** 2 + 1, C), 0.02)
            norms = ["pre_layrnorm", "post_layernorm"]
        in_std = C ** -0.5 * (2 * L) ** -0.5
        for i in range(L):
            layer = f"{pre}.encoder.layers.{i}"
            for x in "qkv":
                put(f"{layer}.self_attn.{x}_proj.weight", (C, C), in_std)
                put(f"{layer}.self_attn.{x}_proj.bias", (C,), 0.02)
            put(f"{layer}.self_attn.out_proj.weight", (C, C), C ** -0.5)
            put(f"{layer}.self_attn.out_proj.bias", (C,), 0.02)
            put(f"{layer}.mlp.fc1.weight", (F_, C), (2 * C) ** -0.5)
            put(f"{layer}.mlp.fc1.bias", (F_,), 0.02)
            put(f"{layer}.mlp.fc2.weight", (C, F_), in_std)
            put(f"{layer}.mlp.fc2.bias", (C,), 0.02)
            norms += [f"encoder.layers.{i}.layer_norm1",
                      f"encoder.layers.{i}.layer_norm2"]
        for norm in norms:
            put(f"{pre}.{norm}.weight", (C,), 0.1, 1.0)
            put(f"{pre}.{norm}.bias", (C,), 0.1)
    P = config["projection_dim"]
    for tower, name in (("vision", "visual_projection.weight"),
                        ("text", "text_projection.weight")):
        C = config[f"{tower}_config"]["hidden_size"]
        put(name, (P, C), C ** -0.5)
    state["logit_scale"] = np.array(2.6592, np.float32)
    return state


def textures(rng, n, per, size=CLIP_IMAGE):
    """uint8 frames [n * per, size, size, 3] of n coarse random textures (8
    px cells), each frame with its own noise, and each frame's texture."""
    bases = rng.randint(0, 256, (n, size // 8, size // 8, 3)).astype(
        np.int16).repeat(8, 1).repeat(8, 2)
    labels = np.repeat(np.arange(n), per)
    noise = rng.randint(-24, 25, (labels.size, size, size, 3)).astype(
        np.int16)
    return np.clip(bases[labels] + noise, 0, 255).astype(np.uint8), labels


def fit_clip_projections(config, state, model_dir, frames, labels,
                         categories, prompt, seed):
    """Set ``state``'s two projections by least squares, as training would
    place them: each category's label (``prompt`` of it) and the mean f32
    pooled feature of its frames map to the category's unit target, a
    direction shared by all plus ``CLIP_FIT_SPREAD`` times one of
    ``len(categories)`` orthonormal ones (a matching label and image then
    score 1, others 1 / (1 + spread^2)). A random tower's pooled features
    of different images lie close together, so with random projections
    every decision is a near-tie; the fit gives the directions that tell
    the category means apart a gain that grows with the spread, and the
    bf16 path's error along them with it (the least pairwise cosine of the
    category means is printed)."""
    from multimodal_baby_tpu_torch.evaluation.clip_baseline import (
        CLIPBaseline)
    from multimodal_baby_tpu_torch.models.clip import clip_from_state
    model = clip_from_state(config, state, dtype=torch.float32,
                            device="cuda")
    clip = CLIPBaseline(model=model, processor_name=model_dir)
    n, P = len(categories), config["projection_dim"]
    gen = torch.Generator().manual_seed(seed)
    q = torch.linalg.qr(torch.randn(P, n + 1, generator=gen,
                                    dtype=torch.float64))[0].T
    targets = (q[0] + CLIP_FIT_SPREAD * q[1:]) / math.hypot(
        1.0, CLIP_FIT_SPREAD)
    with torch.no_grad():
        text = model.text_model(**clip.tokenizer(
            [prompt.format(c) for c in categories])).double().cpu()
        pooled = torch.cat([
            model.vision_model(clip.preprocess(frames[i:i + 64])).double()
            for i in range(0, len(frames), 64)]).cpu()
    means = torch.stack([pooled[torch.from_numpy(labels == c)].mean(0)
                         for c in range(n)])
    unit = F.normalize(means, dim=1)
    log(f"  fitted the projections to {n} categories: their mean pooled "
        f"f32 features at pairwise cosine >= "
        f"{float((unit @ unit.T).min()):.7f}")
    state["text_projection.weight"] = (
        targets.T @ torch.linalg.pinv(text.T)).float().numpy()
    state["visual_projection.weight"] = (
        targets.T @ torch.linalg.pinv(means.T, rtol=1e-4)).float().numpy()
    del model, clip
    torch.cuda.empty_cache()


def write_clip_dir(model_dir, config, state, words):
    """The HF layout, by the port's own writer: config.json, the weights
    as f16 model.safetensors, vocab.json and merges.txt."""
    from multimodal_baby_tpu_torch.api.hf_dir import write_safetensors
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    vocab, merges = clip_vocab(words)
    (model_dir / "vocab.json").write_text(json.dumps(vocab))
    (model_dir / "merges.txt").write_text("#version: 0.2\n" + "".join(
        f"{a} {b}\n" for a, b in merges))
    if state is not None:
        write_safetensors(model_dir / "model.safetensors", {
            k: v.astype(np.float16) for k, v in state.items()})


def clip_kernels(name, spec, card):
    """K5 and K6 at a CLIP vision tower's shapes (eps 1e-5, K6 in the
    sigmoid form), against their plain versions with phase 2b's gates,
    then timed at the main path's largest batch beside the plain versions
    and the library chain, per tower forward, with the bound."""
    gen = torch.Generator().manual_seed(15)
    v = spec["vision"]
    C, F_, heads, depth = (v["hidden_size"], v["intermediate_size"],
                           v["num_attention_heads"], v["num_hidden_layers"])
    N = (CLIP_IMAGE // v["patch_size"]) ** 2 + 1
    scale = (C // heads) ** -0.5
    for B in CLIP_KERNEL_BATCHES[name]:
        xa, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
        xm, pm = vit_half_inputs(gen, "mlp", B, N, C, F_)
        runs = {
            "K5": (lambda: fused_block_attention(xa, *pa, heads, scale, None,
                                                 1e-5),
                   lambda: block_attention_reference(xa, *pa, heads, scale,
                                                     None, 1e-5),
                   attention_library(xa, pa, heads, 1e-5),
                   2 * B * N * C * 4 * C + 4 * B * N * N * C,
                   2 * (2 * B * N * C) + 2 * 4 * C * C),
            "K6": (lambda: fused_mlp(xm, *pm, 1e-5, "sigmoid"),
                   lambda: mlp_reference(xm, *pm, 1e-5, "sigmoid"),
                   mlp_library(xm, pm, 1e-5, "sigmoid"), 4 * B * N * C * F_,
                   2 * (2 * B * N * C) + 2 * 2 * C * F_)}
        for kname, (kernel, plain, library, flops, nbytes) in runs.items():
            with torch.no_grad():
                check(f"{kname} {name} B={B} N={N} C={C}", kernel(), plain())
            if B != max(CLIP_KERNEL_BATCHES[name]):
                continue
            with torch.no_grad():
                k, p, li = time_in_turns(kernel, plain, library, 20)
            total = {}
            launch_bound(total, flops, nbytes, depth)
            log(f"  {kname} {name} per vision forward at B={B} ({depth} "
                f"launches; {card}): kernel {depth * k:.3f} ms, plain "
                f"{depth * p:.3f} ms, library bf16 {depth * li:.3f} ms, "
                f"bound {total['bound_ms']:.3f} ms ({total['bound_by']}); "
                f"kernel {flops / k / 1e9:.1f} TFLOP/s")


@contextlib.contextmanager
def counted_calls(baseline):
    """Each ``score_image_trials`` call's logits, and the seconds spent in
    ``encode_image`` and ``encode_text`` (synchronized)."""
    logits, seconds = [], {"image": 0.0, "text": 0.0}

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds[kind] += time.perf_counter() - t0
            return out
        return run

    score = baseline.score_image_trials
    baseline.encode_image = timed("image", baseline.encode_image)
    baseline.encode_text = timed("text", baseline.encode_text)
    def score_image_trials(*args):
        logits.append(score(*args))
        return logits[-1]

    baseline.score_image_trials = score_image_trials
    try:
        yield logits, seconds
    finally:
        for attr in ("encode_image", "encode_text", "score_image_trials"):
            del baseline.__dict__[attr]


def zero_vit_counts():
    for fn, attr in VIT_COUNTERS:
        setattr(fn, attr, 0)


def vit_counts():
    return [getattr(fn, attr) for fn, attr in VIT_COUNTERS]


def phase_clip_forced_choice(root, card):
    """15a: the ViT-L/14 baseline's forced choice."""
    from multimodal_baby_tpu_torch.evaluation.clip_baseline import (
        CLIPBaseline, run_clip_forced_choice)
    from multimodal_baby_tpu_torch.models.clip import load_clip
    name, spec = "ViT-L/14", CLIP_SPECS["ViT-L/14"]
    depth = spec["vision"]["num_hidden_layers"]
    rng = np.random.RandomState(15)
    frames, labels = textures(rng, len(EVAL_CATS), 4)
    model_dir = root / "clip-vit-large-patch14"
    config = clip_config_json(spec)
    words = ["a", "photo", "of", *EVAL_CATS]
    t0 = time.perf_counter()
    write_clip_dir(model_dir, config, None, words)
    state = random_clip_state(config, 15)
    fit_clip_projections(config, state, model_dir, frames, labels,
                         EVAL_CATS, "a photo of a {}", 15)
    write_clip_dir(model_dir, config, state, words)
    del state
    log(f"  wrote {name} (f16 safetensors, "
        f"{(model_dir / 'model.safetensors').stat().st_size / 2**20:.0f} "
        f"MiB) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern = CLIPBaseline(model_name=str(model_dir))
    torch.cuda.synchronize()
    log(f"  load_clip + tokenizer on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    plain = CLIPBaseline(model=load_clip(model_dir, dtype=torch.float32),
                         processor_name=str(model_dir))
    # one vision forward: K5 and K6 once per block
    x = kern.preprocess(frames[:CLIP_BATCH * 4])
    zero_vit_counts()
    img = kern.model.get_image_features(x)
    counts = vit_counts()
    log(f"  {name} vision forward at B={x.shape[0]}: K5, K6 launches "
        f"{counts}")
    if counts != [depth, depth]:
        raise AssertionError(f"{name}: launches {counts} per forward, want "
                             f"{[depth, depth]}")
    pooled = (kern.model.vision_model(x), plain.model.vision_model(x))
    cos_pooled = row_cosines(*pooled)
    cos_img = row_cosines(img, plain.model.get_image_features(x))
    prompts = [f"a photo of a {c}" for c in EVAL_CATS]
    cos_txt = row_cosines(torch.from_numpy(kern.encode_text(prompts)),
                          torch.from_numpy(plain.encode_text(prompts)))
    log(f"  {name} kernel path vs f32 plain: pooled cos min "
        f"{float(cos_pooled.min()):.7f}, image features min "
        f"{float(cos_img.min()):.7f} mean {float(cos_img.mean()):.7f}, "
        f"text features min {float(cos_txt.min()):.7f}")
    for what, cos in (("image", cos_img), ("text", cos_txt)):
        if not float(cos.min()) >= SLICE_COS_TOL:
            raise AssertionError(f"{name} {what} features: cosine "
                                 f"{float(cos.min()):.7f} < {SLICE_COS_TOL}")
    (root / "clip_eval").mkdir()
    path, _ = write_eval_set(root / "clip_eval", rng, frames, labels,
                             n_trials=CLIP_TRIALS)
    data = load_metadata(path)
    vocab = Vocab({t["target_category"]: i for i, t in enumerate(data)})
    dataset = Decoded(EvalTrialDataset(data, vocab))
    forwards = -(-len(dataset) // CLIP_BATCH)
    runs = {}
    for what, baseline in (("kernels", kern), ("f32 plain", plain)):
        with counted_calls(baseline) as (logits, seconds):
            zero_vit_counts()
            acc, records = run_clip_forced_choice(baseline, dataset)
            counts = vit_counts()
        runs[what] = (acc, records, np.concatenate(logits), counts)
        log(f"  {name} forced choice, {what}: accuracy {acc:.4f} over "
            f"{len(records)} trials; K5, K6 launches {counts}")
    acc, records, logits, counts = runs["kernels"]
    if counts != [depth * forwards] * 2:
        raise AssertionError(f"{name} forced choice: launches {counts}, want "
                             f"{[depth * forwards] * 2} ({forwards} vision "
                             f"forwards)")
    _, records_f32, logits_f32, _ = runs["f32 plain"]
    top2 = np.sort(logits_f32, -1)
    clear = top2[:, -1] - top2[:, -2] > CLIP_GAP
    same = np.array([a["pred"] == b["pred"]
                     for a, b in zip(records, records_f32)])
    log(f"  {name} decisions: equal on {int(same.sum())} of {same.size} "
        f"trials, on {int(same[clear].sum())} of {int(clear.sum())} with an "
        f"f32 top-two gap > {CLIP_GAP}; max logit difference "
        f"{float(np.abs(logits - logits_f32).max()):.3e}")
    if not same[clear].all():
        raise AssertionError(f"{name}: decisions differ where the f32 gap "
                             f"exceeds {CLIP_GAP}")
    times = {}
    for what, baseline in (("kernels", kern), ("f32 plain", plain)):
        with counted_calls(baseline) as (_, seconds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CLIP_TIMED):
                run_clip_forced_choice(baseline, dataset)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        times[what] = elapsed
        log(f"  {name} forced choice, {what} ({card}): "
            f"{CLIP_TIMED * len(dataset) / elapsed:.1f} trials/s on decoded "
            f"frames; encode_image {seconds['image'] / CLIP_TIMED * 1e3:.1f}"
            f" ms, encode_text {seconds['text'] / CLIP_TIMED * 1e3:.1f} ms "
            f"of {elapsed / CLIP_TIMED * 1e3:.1f} ms a pass of "
            f"{len(dataset)} trials")
    del kern, plain
    torch.cuda.empty_cache()


def phase_clip_filter(root, card):
    """15b: the ETL's eval-frame filter with its default scorer, the
    ViT-B/16 baseline, from the Hugging Face cache layout."""
    import os
    from PIL import Image
    from multimodal_baby_tpu_torch.data import etl
    from multimodal_baby_tpu_torch.evaluation.clip_baseline import (
        CLIPBaseline)
    from multimodal_baby_tpu_torch.models.clip import load_clip
    name, spec = "ViT-B/16", CLIP_SPECS["ViT-B/16"]
    depth = spec["vision"]["num_hidden_layers"]
    rng = np.random.RandomState(16)
    cats = LABELED_S_CATS
    n, per = len(cats), CLIP_PER_CATEGORY
    frames, labels = textures(rng, n, per + 1)
    labeled = root / "clip_labeled_s"
    for c, cat in enumerate(cats + EXCLUDED_CATS):
        (labeled / cat).mkdir(parents=True)
        # the category's own frames, and the next category's last frame,
        # which the filter drops (an excluded category gets one frame)
        chosen = ([*frames[c * (per + 1):c * (per + 1) + per],
                   frames[((c + 1) % n) * (per + 1) + per]] if c < n
                  else [frames[0]])
        for k, img in enumerate(chosen):
            Image.fromarray(img).save(labeled / cat / f"{k:03d}.jpeg",
                                      quality=90)
    hub = root / "clip_hf" / "hub" / "models--openai--clip-vit-base-patch16"
    model_dir = hub / "snapshots" / "0123456789abcdef"
    (hub / "refs").mkdir(parents=True)
    (hub / "refs" / "main").write_text("0123456789abcdef")
    config = clip_config_json(spec)
    words = ["a", "photo", "of", *cats]
    write_clip_dir(model_dir, config, None, words)
    state = random_clip_state(config, 16)
    keep = np.arange(len(labels)) % (per + 1) != per
    fit_clip_projections(config, state, model_dir, frames[keep],
                         labels[keep], cats, "{}", 16)
    write_clip_dir(model_dir, config, state, words)
    del state
    saved = {k: os.environ.pop(k, None) for k in ("HF_HOME", "HF_HUB_CACHE")}
    os.environ["HF_HOME"] = str(root / "clip_hf")
    try:
        zero_vit_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = etl.filter_eval_frames(labeled, root / "clip_filtered")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = vit_counts()
    finally:
        os.environ.pop("HF_HOME")
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    forwards = n   # one chunk a category
    log(f"  {name} filter_eval_frames, default scorer from the cache "
        f"layout: kept {kept} of {n * (per + 1)} frames (the fit: "
        f"{n * per}) in {seconds:.2f} s ({card}, model load included); K5, K6 "
        f"launches {counts}")
    if counts != [depth * forwards] * 2:
        raise AssertionError(f"{name} filter: launches {counts}, want "
                             f"{[depth * forwards] * 2}")
    clip = CLIPBaseline(model=load_clip(model_dir, dtype=torch.float32),
                        processor_name=str(model_dir))
    text_features = clip.encode_text(list(cats))

    def plain_scorer(images_u8, _):
        return (clip.encode_image(images_u8) @ text_features.T).argmax(-1)

    kept_plain = etl.filter_eval_frames(labeled, root / "clip_plain",
                                        scorer=plain_scorer)
    listing = [sorted(str(p.relative_to(d)) for p in d.rglob("*.jpeg"))
               for d in (root / "clip_filtered", root / "clip_plain")]
    log(f"  {name} f32 plain scorer: kept {kept_plain}; the same frames: "
        f"{listing[0] == listing[1]}")
    if listing[0] != listing[1] or kept == 0:
        raise AssertionError(f"{name} filter: the kernel path kept {kept} "
                             f"frames, the f32 plain scorer {kept_plain}, "
                             f"not the same set")
    del clip
    torch.cuda.empty_cache()


def phase_clip(root, card):
    """Phase 15: the CLIP baseline on its towers."""
    t0 = time.perf_counter()
    for name, spec in CLIP_SPECS.items():
        clip_kernels(name, spec, card)
    phase_clip_forced_choice(root, card)
    phase_clip_filter(root, card)
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

# ----------------------------------------------------------------- phase 2g
K12_BATCH = 512  # the train cell's batch: K12 serves BN on batch statistics


def bn_shapes(batch: int = K12_BATCH, size: int = 224):
    """The batch-statistics BatchNorms of one ResNeXt-50 forward, grouped:
    ((M, C, residual) -> (count, names)), residual "none" (the stem, bn1,
    bn2), "identity" or "downsample" (bn3, the downsample's BatchNorm
    fused into its apply): 49 apply launches and 53 statistics passes."""
    shapes = collections.OrderedDict()

    def add(name, H, C, residual="none"):
        entry = shapes.setdefault((batch * H * H, C, residual), [0, []])
        entry[0] += 1
        entry[1].append(name)

    add("stem", size // 2, 64)
    H = size // 4
    for i, (planes, blocks, stride) in enumerate(RESNEXT50_STAGES):
        for b in range(blocks):
            s = stride if b == 0 else 1
            Ho = (H - 1) // s + 1
            add(f"layer{i + 1}.{b}.bn1", H, planes * 2)
            add(f"layer{i + 1}.{b}.bn2", Ho, planes * 2)
            add(f"layer{i + 1}.{b}.bn3", Ho, planes * 4,
                "downsample" if b == 0 else "identity")
            H = Ho
    return shapes


def graph_ms(fn, calls: int = 10) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed and timed with events, so the host's launch path is
    left out (around eager calls the events time the host wherever it is
    slower than the card)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # per-stream state (K12's tickets) made before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def phase_batch_norm():
    """K12 (``ops/batch_norm.py``) at every batch-statistics BatchNorm
    shape of a B = 512 forward: the kernel pair (through
    ``InferenceBN.forward_relu``) against the plain path (``InferenceBN``'s
    body, ReLU and the residual add, as the conv path ran before K12) and
    ``F.batch_norm`` (training mode, the library yardstick only); outputs
    within phase 2's gate, mul and add within 1e-5 of the plain version's,
    two calls equal bit for bit. Times each in turns (events), the
    statistics and apply launches alone too, and K12's calls also as
    replays of a CUDA graph (``graph_ms``: at the small shapes the events
    time the host's calls), against the bytes bound (x, the residual and
    the output once each at 3.35 TB/s)."""
    gen = torch.Generator().manual_seed(25)
    total = collections.Counter()
    err = 0.0
    for (M, C, residual), (count, names) in bn_shapes().items():
        H = int(round(math.sqrt(M / K12_BATCH)))
        x = (torch.randn(K12_BATCH, H, H, C, generator=gen) + 0.3).to(
            "cuda", torch.bfloat16).permute(0, 3, 1, 2)
        r = (None if residual == "none" else
             torch.relu(torch.randn(K12_BATCH, H, H, C, generator=gen)).to(
                 "cuda", torch.bfloat16).permute(0, 3, 1, 2))
        bns = []
        for _ in range(2):
            bn = InferenceBN(C, device="cuda").requires_grad_(False)
            with torch.no_grad():
                bn.weight.copy_(1 + 0.1 * torch.randn(C, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(C, generator=gen))
            bns.append(bn)
        bn, ds = bns[0], (bns[1] if residual == "downsample" else None)

        def kernel():
            return bn.forward_relu(x, True, r, ds)

        def plain():
            y = bn(x, True)
            if r is not None:
                y = y + (r if ds is None else ds(r, True))
            return torch.relu(y)

        def library():
            def fbn(t, m):
                return F.batch_norm(t, m.running_mean, m.running_var,
                                    m.weight, m.bias, True, 0.1, BN_EPS)
            y = fbn(x, bn)
            if r is not None:
                y = y + (r if ds is None else fbn(r, ds))
            return torch.relu(y)

        rows = x.permute(0, 2, 3, 1).view(M, C)
        buf = (bn.running_mean.clone(), bn.running_var.clone())

        def stats():
            return batch_norm_stats(rows, bn.weight, bn.bias, *buf)

        fold = stats()

        def apply():
            return batch_norm_apply(rows, fold)

        with torch.no_grad():
            before = batch_norm_apply.launches
            got = kernel()
            if batch_norm_apply.launches - before != 1:
                raise AssertionError(f"K12 M={M} C={C}: "
                                     f"{batch_norm_apply.launches - before} "
                                     f"apply launches in one call")
            again = kernel()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K12 M={M} C={C}: two calls differ")
            tag = f"K12 M={M} C={C} {residual}"
            err = max(err, check(tag, got, plain()))
            want = batch_norm_stats_reference(rows, bn.weight, bn.bias,
                                              *(t.clone() for t in buf))
            for what, a, b in zip(("mul", "add"), fold, want):
                rel = float((a - b).double().norm() / b.double().norm())
                if not rel <= 1e-5:
                    raise AssertionError(f"{tag}: {what} rel {rel:.3e}")
            del got, again, want
            iters = max(3, min(50, int(4e9 / (M * C * 2))))
            kms, pms, lms = time_in_turns(kernel, plain, library, iters)
            sms = time_ms(stats, iters)
            ams = time_ms(apply, iters)
            gk, gs, ga = (graph_ms(fn) for fn in (kernel, stats, apply))
        moved = M * C * 2 * (3 if r is not None else 2)
        bms = moved / PEAK_BYTES * 1e3
        log(f"  K12 M={M:>8d} C={C:>4d} {residual:10s} x{count:<2d}, eager "
            f"/ graph ms: kernel pair {kms:.4f} / {gk:.4f} (stats "
            f"{sms:.4f} / {gs:.4f}, residual-free apply {ams:.4f} / "
            f"{ga:.4f}; bound {bms:.4f}, {100 * bms / gk:.1f}% of the "
            f"graph's time), plain {pms:.4f}, F.batch_norm {lms:.4f} "
            f"({', '.join(names[:2])}{', ...' if count > 2 else ''})")
        for key, v in (("ms", kms), ("plain_ms", pms), ("library_ms", lms),
                       ("stats_ms", sms), ("apply_ms", ams),
                       ("graph_ms", gk), ("stats_graph_ms", gs),
                       ("apply_graph_ms", ga)):
            total[key] += count * v
        launch_bound(total, 0.0, moved, count)
        del x, r, rows
        torch.cuda.empty_cache()
    t = total
    log(f"  K12 over the 53 BatchNorms of one B={K12_BATCH} forward (the "
        f"shape classes by count), eager / graph ms: kernel pair "
        f"{t['ms']:.3f} / {t['graph_ms']:.3f} (statistics "
        f"{t['stats_ms']:.3f} / {t['stats_graph_ms']:.3f}, the applies "
        f"without residual {t['apply_ms']:.3f} / {t['apply_graph_ms']:.3f}"
        f"), bound "
        f"{t['bound_ms']:.3f} ms ({100 * t['bound_ms'] / t['graph_ms']:.1f}%"
        f" of the graph's time), plain {t['plain_ms']:.3f}, F.batch_norm "
        f"{t['library_ms']:.3f}")
    stats_n, apply_n, trunk_ms = trunk_train_launches()
    return {"launches": stats_n + apply_n, "max_abs_err": err, **total,
            "stats_launches": stats_n, "apply_launches": apply_n,
            "trunk_train_ms": trunk_ms}


def trunk_train_launches(batch: int = K12_BATCH, size: int = 224):
    """K12's launches in one train-mode (batch statistics) forward of a
    frozen bf16 ResNeXt-50 on the card at the train cell's batch, the
    conv path that K12 serves, counted from zero: (statistics launches,
    apply launches, the forward's ms). Raises unless they are 53 and 49
    and the pooled output is finite. Each block's bn3 gain is 0.2, as the
    benchmark's configuration assumes."""
    gen = torch.Generator().manual_seed(25)
    trunk = ResNeXt50(torch.bfloat16, frozen=True, device="cuda",
                      generator=gen).requires_grad_(False)
    with torch.no_grad():
        for block in trunk.blocks():
            block.bn3.weight.mul_(0.2)
        x = torch.randn(batch, size, size, 3, device="cuda",
                        dtype=torch.bfloat16,
                        generator=torch.Generator("cuda").manual_seed(25))
        trunk(x, train=True)  # warm: cuDNN's plans
        torch.cuda.synchronize()
        batch_norm_stats.launches = batch_norm_apply.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pooled = trunk(x, train=True)["pooled"]
        end.record()
        torch.cuda.synchronize()
    counts = (batch_norm_stats.launches, batch_norm_apply.launches)
    ms = start.elapsed_time(end)
    log(f"  K12 in one B={batch} {size} px train-mode trunk forward (bf16, "
        f"the conv path): {counts[0]} statistics launches, {counts[1]} "
        f"apply launches, {ms:.3f} ms")
    if counts != (53, 49) or not bool(torch.isfinite(pooled).all()):
        raise AssertionError(f"K12 in the train-mode trunk: launches "
                             f"{counts} (want (53, 49)), pooled finite "
                             f"{bool(torch.isfinite(pooled).all())}")
    del trunk, x, pooled
    torch.cuda.empty_cache()
    return (*counts, ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):  # registers and spills per kernel
        if "Function properties for" in line and i + 2 < len(lines):
            log(f"  ptxas: ...{line.split('for ')[-1][-44:]}: "
                f"{lines[i + 2].split(': ', 1)[-1]}; {lines[i + 1].strip()}")
    # (name, mangled kernel name, its forms: template arguments -> what)
    passes = {"Lb1EEEv": "one pass", "Lb0EEEv": "two passes"}
    for name, kernel, forms in (
            ("K5 attention", "13attention_mmaILi2E", passes),
            ("Dense tile", "8vit_gemmI", {
                "13RoundThenBias": "RoundThenBias (K5 qkv)",
                "12ResidualBias": "ResidualBias (K5 proj)",
                **{f"BiasGeluFormILi{m}E": f"BiasGelu {g} (probe)"
                   for m, g in enumerate(GELU_MODES)}}),
            ("K6 ping-pong tile", "12vit_pingpongI", {
                **{f"12PingPongGeluILi{m}E": f"fc1, GELU {g}"
                   for m, g in enumerate(GELU_MODES)},
                "16PingPongResidual": "fc2, residual"}),
            ("K7", "16vit_block_kernelI", passes),
            ("K8a", "13attention_mmaILi0E", passes),
            ("K8b", "13attention_mmaILi1E", passes),
            ("K8c", "17qkv_attention_mmaI", passes),
            ("K10b", "16bottleneck_fusedI", {f"Li{cg}EEEv": f"cg {cg}"
                                           for cg in (4, 8, 16, 32)}),
            ("K1 1x1 tile", "9conv_gemmI", CONV_TILE_FORMS),
            ("K12 statistics", "15bn_stats_kernel", {"bn_stats": "f32"}),
            ("K12 apply", "15bn_apply_kernelI", {
                "ILi0E": "no residual", "ILi1E": "identity",
                "ILi2E": "downsample"}),
            ("K2/K3a int8 1x1 tile", "12conv_gemm_s8I", {
                "ILi0E": "conv1", "ILi1E": "conv3, residual",
                "ILi2E": "conv3, downsample"}),
            ("K10a 1x1 launches", "11conv_gemm_tI", {
                "ILi0E": "conv1 on the codes", "ILi1E": "conv3, residual",
                "ILi2E": "conv3, downsample"}),
            ("K1 grouped 3x3", "10gconv_haloI", {
                f"ILi{cg}EEEv": f"cg {cg}" for cg in (4, 8, 16, 32)}),
            ("K2 grouped 3x3", "13gconv_halo_s8I", {
                f"ILi{cg}EEEv": f"cg {cg}" for cg in (4, 8, 16, 32)}),
            ("K3a/K3b stage", "17stage_tile_kernelI", {
                **{f"9StageStepELi{cg}E": f"bf16, cg {cg}"
                   for cg in (4, 8, 16, 32)},
                **{f"11StageStepS8ELi{cg}E": f"int8, cg {cg}"
                   for cg in (4, 8, 16, 32)},
                **{f"10StageStepTELi{cg}E": f"transport, cg {cg}"
                   for cg in (4, 8, 16, 32)}})):
        found = [i for i, line in enumerate(lines)
                 if "Function properties for" in line and kernel in line]
        if len(found) != len(forms):
            raise AssertionError(f"ptxas reported {len(found)} {kernel} "
                                 f"kernels, expected {len(forms)}")
        for i in found:
            form = next(v for k, v in forms.items() if k in lines[i])
            log(f"  ptxas {name} ({kernel.strip('0123456789I')}, {form}): "
                f"{lines[i + 2].split(': ', 1)[-1]}; {lines[i + 1].strip()}")
        if name[:2] == "K8" or name == "K5 attention":
            log(f"  {name} dynamic shared memory at N = 257: "
                f"{attention_geometry(257, qkv=name == 'K8c').smem} bytes")
    for line in lines:  # a serialized or rescheduled wgmma in K6's tile
        if "vit_pingpong" in line and ("C75" in line or "wgmma" in line):
            log(f"  ptxas K6 ping-pong tile: {line.strip()}")
    # the kernels of K1, K2, K10a, K11 and the stage bodies on the wgmma
    # tiles: no spills, no wgmma serialized or waited on by the compiler
    for i, line in enumerate(lines):
        new = any(k in line for k in ("9conv_gemmI", "12conv_gemm_s8I",
                                      "11conv_gemm_tI",
                                      "17stage_tile_kernelI",
                                      "10gconv_haloI", "13gconv_halo_s8I"))
        if new and ("C75" in line or "wgmma" in line):
            raise AssertionError(f"ptxas on K1, K2, K3a/b, K10a or K11: "
                                 f"{line.strip()}")
        if (new and "Function properties for" in line
                and "0 bytes spill stores, 0 bytes spill loads"
                not in lines[i + 1]):
            raise AssertionError(f"ptxas on K1, K2, K3a/b, K10a or K11: "
                                 f"{line.strip()}: {lines[i + 1].strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = mlp_geometry(BATCH * 257, 768, 3072, sms)
    log(f"  K6 at the ViT slice (M = {BATCH * 257}): {geo}")
    geo = tiles_geometry(56, 56, 256, 256, 512, 2, True)
    log(f"  K10b at layer 2's head: {geo}")
    for name, H, cin, width, cout, stride, ds, _ in (BLOCKS_224[0],
                                                      BLOCKS_224[-2]):
        geo = block_geometry(BATCH, H, H, cin, width, cout, stride, ds, sms)
        log(f"  K1's 1x1 tile at {name} (B = {BATCH}): conv1, conv3 {geo}")
    for name, H, cin, width, cout, stride, ds in Q_BLOCKS_224[::2]:
        geo = block_geometry_s8(BATCH, H, H, cin, width, cout, stride, ds,
                                sms)
        log(f"  K2's int8 tile at {name} (B = {BATCH}): conv1, conv3 {geo}")

    log("phase 2: K1 against its plain version")
    k1 = phase_k1()
    log("phase 2b: K5 and K6 against their plain versions")
    vit_kernels = phase_vit_kernels()
    log("phase 2c: K2, K3a and K3b against their plain versions")
    q = phase_int8_and_stages()
    log("phase 3: the ResNeXt slice, per-block plan")
    k1["launches"] = phase_resnext_slice()
    log("phase 2d: K7, K8a, K8b and K8c against their plain versions")
    vit_kernels.update(phase_vit_more_kernels())
    log("phase 4: the ViT slice")
    (vit_kernels["K5"]["launches"], vit_kernels["K6"]["launches"]), vit = \
        phase_vit_slice()
    log("phase 5: the published flagship, int8 layers 3-4, default plan")
    (_, q["K2"]["launches"], q["K3a"]["launches"],
     q["K3b"]["launches"]), published, phase5_step_s = \
        phase_published_flagship()
    log("phase 6: the ViT slice in its other kernel configurations")
    for name, n in phase_vit_configs(*vit).items():
        vit_kernels[name]["launches"] = n
    log("phase 2e: K9 and K4 against their plain versions")
    k9 = phase_lstm_kernel()
    k4 = phase_infonce_kernels()
    log("phase 7: the LSTM text encoders and their language model")
    (k9["launches"], k4["fwd"]["launches"],
     k4["bwd"]["launches"]), joint = phase_lstm_slice()
    log("phase 2f: K10a, K10b and K11 against their plain versions")
    t = phase_transport_kernels()
    log("phase 2g: K12 against its plain version at the 53 BatchNorms of a "
        "B = 512 train-mode forward")
    t["K12"] = phase_batch_norm()
    log("phase 8: the int8-transport trunk plans, K10b and K11 entry points")
    for name, n in phase_transport_slice(published).items():
        t[name]["launches"] = n
    log("phase 9: forced-choice evaluation, the five-call API and the probe")
    phase_eval_and_api(published, vit[1], card)
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 10: the trainer, checkpoints, resume and load_model")
        phase_trainer(card, phase5_step_s, Path(tmp))
        log("phase 11: text generation, grad-CAM and the analyses that run "
            "a model")
        phase_analyses(published, joint, card)
        log("phase 12: the host input path, the host-only analysis chain "
            "and the sweep runner")
        phase_host_input(Path(tmp), published, card)
        log("phase 13: the ETL and COCO, local backbone checkpoints and "
            "the distributed step")
        phase_etl_coco_backbones_distributed(Path(tmp), published,
                                             phase5_step_s, card)
        log("phase 14: the opt-in stems and augment forms, the "
            "differentiable K1 and the kernel flags of cli/train")
        phase_opt_in_modes(Path(tmp), published)
        log("phase 15: the CLIP baseline, ViT-L/14 forced choice and the "
            "ViT-B/16 eval-frame filter, on K5 and K6")
        phase_clip(Path(tmp), card)

    csrc = "multimodal_baby_tpu_torch/ops/csrc/"
    hwbc = "multimodal_baby_tpu/ops/bottleneck_hwbc.py"
    rows = [("fused_bottleneck", "conv_gemm.cuh", f"{hwbc}:408", k1),
            ("fused_bottleneck_int8", "conv_gemm_s8.cuh", f"{hwbc}:408",
             q["K2"]),
            ("fused_stage", "conv_gemm_s8.cuh", f"{hwbc}:758", q["K3a"]),
            ("fused_stage_banded", "conv_gemm.cuh", f"{hwbc}:1078",
             q["K3b"]),
            ("fused_block_attention", "vit_attention.cu",
             "multimodal_baby_tpu/ops/attention.py:601", vit_kernels["K5"]),
            ("fused_mlp", "vit.cu", "multimodal_baby_tpu/ops/vit_mlp.py:186",
             vit_kernels["K6"]),
            ("fused_vit_block", "vit_block.cu",
             "multimodal_baby_tpu/ops/vit_block.py:130", vit_kernels["K7"]),
            ("fused_attention", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:90", vit_kernels["K8a"]),
            ("fused_attention_pairs", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:239", vit_kernels["K8b"]),
            ("fused_qkv_attention_pairs", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:392", vit_kernels["K8c"]),
            ("fused_infonce_forward", "infonce.cu",
             "multimodal_baby_tpu/ops/infonce.py:145", k4["fwd"]),
            ("fused_infonce_backward", "infonce.cu",
             "multimodal_baby_tpu/ops/infonce.py:171", k4["bwd"]),
            ("lstm_fused", "lstm.cu", "multimodal_baby_tpu/ops/lstm.py:147",
             k9),
            ("fused_bottleneck_transport", "bottleneck.cu", f"{hwbc}:408",
             t["K10a block"]),
            ("fused_stage_transport", "stage.cu", f"{hwbc}:758",
             t["K10a stage"]),
            ("fused_stage_banded_transport", "stage.cu", f"{hwbc}:1078",
             t["K10a banded"]),
            ("fused_bottleneck_tiles", "bottleneck_fused.cu", f"{hwbc}:531",
             t["K10b"]),
            ("conv1x1_bn_residual_relu", "conv_epilogue.cu",
             "multimodal_baby_tpu/ops/conv_epilogue.py:78", t["K11"]),
            ("batch_norm_stats + batch_norm_apply", "batch_norm.cu",
             "none (XLA fuses the JAX package's BatchNorm)", t["K12"])]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": replaces, **{k: res[k] for k in keys}}
        for name, src, replaces, res in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
