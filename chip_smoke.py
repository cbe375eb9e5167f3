#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. torch / CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from catseg_tpu_torch/csrc (one nvcc per source,
   all at once, at first use).
3. Each of the twelve kernels against its plain PyTorch version on the card,
   in fp32 (TF32 off) and bf16: the six forward kernels at the serving
   slice's shapes (2 images = 10 tiles, T = 150, 1500 decoder slabs; the
   class layer also at T = 256, the top-k path's count), the three backward
   kernels at the train step's (4 images, T = 171, the class layer on the
   12x12 pooled grid, 684 decoder slabs; every gradient checked by its
   relative Frobenius error, the worst max-norm error logged beside it),
   the three kernels of the aggregator's unfused stages at the serving
   slab's (window attention over 6000 windows of 144 tokens; the class MLP
   at 1,474,560 rows and the Swin MLP at 864,000; linear attention over 5760
   sequences of 256 classes; window attention also on the strided views
   of a fused qkv projection with no mask, as the unfused Swin block's
   unshifted half calls it, and at window 16, 1500 windows of 256 tokens;
   window attention (6000 windows of 144 x 128, the shift mask) and linear
   attention (5760 x 256 x 128) at one head of 128, vitb384(num_heads=1)'s
   shapes, as window_attention@D128 and linear_attention@D128; the Swin
   MLP at hidden 512, 512 -> 2048 -> 512 over 864,000 tokens, and window
   attention over 6000 windows of 144 x 512 at 4 heads of 128, the shift
   mask, vitb384(hidden_dim=512)'s shapes, as mlp@512 and
   window_attention@C512; window attention over 6000 windows of 144 x 384
   at 4 heads of 96 and of 144 x 256 at one head, linear attention over
   5760 x 256 x 384 at 4 heads of 96 and 5760 x 256 x 256 at one head,
   vitb384(hidden_dim=384)'s and vitb384(hidden_dim=256, num_heads=1)'s
   shapes, as window_attention@D96 / @D256 and linear_attention@D96 /
   @D256, drawn on the device after every other case):
   each case's kernel call must raise its
   kernel's launch count; the error against the stated bound, kernel,
   plain and (where one PyTorch call computes the same function) library
   times and kernel / library, median of CUDA-event timings after warm-up
   (a call under 1 ms timed over 20 back-to-back calls).  Also at the larger
   encoder tiers' shapes: LayerNorm at rows of 1024, 1280 and 1664, the dense
   attention at 16 heads of 64 (width 1024), the corr embed at E 768, 1024
   and 1280; and the corr embed at the serving shape with C = 256 (E = 512:
   hidden 256, two 128-channel blocks) and with E = 40 and 48 (C = 128:
   text widths not a multiple of 32).
4. The slice at the default configuration: a Predictor at
   eval_preset(vitb384()) — ViT-B/16 at full depth and width, bf16, the
   fused decoder, random weights from seed 0 — on the 150 ADE-20k class
   names; preds_sliding_batch on two synthetic uint8 images of different
   sizes.  Checks shapes, finite probabilities, labels in [0, 150), and that
   every kernel of the default route's launch count rose during that one
   run and the unfused stages' kernels never launched; reports images/s.
4b. The same slice with the plain decoder, eval_preset(vitb384(
   fused_decoder=False)) (the path of the first slice): every kernel but
   the decoder launched in one run, the decoder never; images/s.
5. fp32 parity of the default configuration: one image, the first 20 ADE
   classes, kernel path on the GPU against the same weights through the
   port on the CPU; max |d prob| must stay below 5e-4.
6. The top-k path: the 847 ADE-full names (pad_len 256 kept), bf16, the same
   two images: shapes, probabilities in [0, 1], labels in [0, 847), the
   class-layer and decoder counts rise; images/s.  Then fp32 parity of the
   top-k machinery (pad_len 16, the first 40 ADE-full names, one image, GPU
   against CPU): equal kept class sets, max |d prob| below 5e-4.
7. A ConfusionAccumulator on the card fed phase 4's predictions against a
   seeded synthetic ground truth with ignore pixels: its matrix must equal a
   numpy bincount of the same pairs.
8. The train step at full width: vitb384() (bf16, pooling 2x2, fused
   decoder, CLIP q/v finetune, AdamW recipe), seed 0, the 171 COCO-Stuff
   train prompts, 4 synthetic 384^2 crops with targets in [0, 171) and ~10%
   ignore: one counted warm-up step (every forward and backward kernel
   launched, the unfused stages' never; finite loss), 10 steps each timed
   on the host clock to a synchronize (ms/step as median, min and max;
   images/s at the median), frozen parameters bit-equal and > 90% of the
   trainable tensors moved.
9. fp32 train-step parity, vitb384(compute_dtype="float32"), 1 crop, the
   first 8 classes (pad terms live), the same weights on the GPU (kernels)
   and the CPU (the port's plain path): loss within 1e-5 relative, every
   trainable gradient before the clip within 1e-3 of its largest CPU value,
   and after one update frozen tensors equal and trainables moved.
10. Serving with attention_type="full" (the reference's other class
   aggregation): eval_preset(vitb384(attention_type="full")), bf16, the
   same two images at T = 150.  Every class layer takes the unfused stage
   (pad to 256 tokens, LN, fp32 softmax attention, LN, the ReLU MLP kernel
   at 1,474,560 rows): the mlp count rises, the class-layer kernel's stays
   0; shapes, probabilities in [0, 1], labels in range; images/s.
11. Its fp32 parity, GPU against the port on the CPU (1 image, 20 classes):
   max |d prob| below 5e-4, as [5].
12. The train step at vitb384(attention_type="full") (pooling 2x2, B = 4,
   T = 171): the MLP kernel forward at 147,456 rows with the plain
   backward, the class-layer kernels never; finite loss, ms/step over 20
   steps as [8], trainables moved.
13. The unfused stages against the fused kernels at full width, in fp32 and
   bf16, as catseg_tpu's own tests hold them equal: the unfused Swin pair
   (window attention twice, the GELU MLP twice) against fused_swin_pair on
   the serving slab (10, 150, 24, 24, 128) with appearance guidance; the
   unfused linear class stage (linear attention, the ReLU MLP) against the
   class-layer kernel at T = 150, pad_len 256, pooling 1x1, and at the
   train shapes (4, 171) with pooling 2x2.  Bounds: fp32 2e-4, bf16 2^-5,
   of max(1, |fused|); the window-attention, MLP and linear-attention
   counts rise.  Each stage's time on both routes is logged.
14. The bf16 gate (catseg_tpu_torch/tools/bf16_gate.py), as the reference
   bounds its production dtype
   (tests/test_fullscale_parity_more.py::test_bf16_drift_fullscale): one
   seeded 427x640 image, 150 random unit text features, the same seeded
   weights (GATE_SEED; why that seed, the tool says) at
   eval_preset(vitb384(compute_dtype=dt)) for fp32 and bf16,
   probs_sliding_batch on the card both ways.  max |d prob| < 0.02, mean <
   2e-3, and argmax agreement > 0.99 on the pixels whose fp32 top-2 gap
   exceeds 0.01 (there must be some); the bf16 run raises every forward
   kernel's count.
15. The single-image API on the whole-image branch, the model's default
   configuration: Predictor(vitb384()) (sliding_window=False, pooling 2x2,
   bf16, random weights from seed 0) on the 150 ADE-20k names;
   predict_argmax on phase 4's two images.  One counted run must launch
   each forward kernel and no backward or unfused-stage kernel; labels of
   each image's size in [0, 150).  Every forward-kernel call of one
   probs_whole (the class layer on the 12x12 pooled grid outside autograd,
   the decoder at 150 slabs, ...) is recorded and its kernel held against
   its plain version on the same bf16 inputs, at [3]'s bound 2^-5;
   images/s at the median of 20 host-clock 2-image runs, with min and max.
16. fp32 parity of the single-image API, vitb384(compute_dtype="float32"),
   one image, 20 classes, GPU kernels against the port on the CPU:
   probs_whole max |d prob| below 5e-4, predict_argmax's labels equal on >=
   99.9% of pixels; probs_sliding under eval_preset below 5e-4 (against
   phase 5's CPU result, the same function) and equal, exactly, to row 0 of
   probs_sliding_batch on the card.
17. The aggregator's routes at geometries some kernels do not take, and at
   those they were widened to (kernels/selfcheck.py ROUTES: hidden 256,
   one head, hidden 512, hidden 384 at 3, 4 and 16 heads, hidden 256 at
   one head, hidden 192 at 3 and 4 heads, hidden 96, hidden 100 (head dim
   25, rows 100 elements apart), hidden 640, ...), fp32, T = 8, random
   weights and features.  Where a kernel the routes call does not take the
   geometry and the reference's own gate runs its kernel there (linear
   attention at hidden 640), the card must raise NotImplementedError
   naming it; where that gate fails (the MLP and linear attention at hidden
   96, 100 and 192, the MLP at 640) the wrapper runs its plain version, as the reference runs
   its plain composition, and launches nothing; elsewhere the run launches
   exactly the kernels the routes call and do not run plain (LayerNorm
   aside), and its sigmoid probabilities match the port on the CPU below
   5e-4.
18. The host data path: the host C++ library built with this machine's g++;
   every committed fixture (tests/torch_fixtures: JPEGs 4:2:0 / 4:4:4 /
   progressive / grey, L / P / RGBA PNGs, a uint16 TIFF, the 4-image
   dataset) decodes to the sha256 of the imaging library's arrays in
   digests.json, and the 480x640 JPEG's resize_shortest_edge(640, 2560) to
   its digest (and to the resize's numpy specification); decode and resize
   ms of that JPEG, median of 10, on the host CPU.
19. tools.eval.main on the fixture dataset (4 images, two sizes, ADE-150
   layout): vitb384, eval preset, bf16, random weights from seed 0,
   --eval-batch 2 then 1.  Each run launches every forward kernel; 4 images,
   finite metrics, equal metrics and confusion matrices for batch 2 and 1,
   and the matrix equals a ConfusionAccumulator fed
   Predictor.preds_sliding_batch on the same loaded inputs.  Images/s of the
   harness with decode and resize included (median of 3 passes) beside the
   Predictor alone on those inputs and [4]'s.  Then the steady state: the
   harness over 128 entries of the 480x640 JPEG (each with a 480x640 PNG
   label map, written to a temporary ADE-150 layout) beside the Predictor
   alone on the same loaded inputs, and the harness's load ms an image.
20. TTAPredictor with D2's 9 scales (400..1200, max 4000) x hflip on the
   480x640 fixture JPEG (bf16, T = 150): 18 passes an image, probabilities
   finite in [0, 1], every forward kernel launched; ms an image, median of
   3.  Then fp32, scale 400 x hflip, 20 classes: GPU against the port on the
   CPU below 5e-4, as [16].
21. tools.train.main: vitb384 (bf16, pooling 2x2), B = 4, 3 steps on the
   fixture dataset through the train mapper and its prefetch thread:
   finite losses in metrics.json, every forward and backward kernel
   launched, model_final.pth written; then tools.eval --checkpoint of it
   scores the 4 images.  Host ms a batch of 4 of the mapper on 480x640
   JPEGs and label maps, median of 10.  Then tools.train --config
   fusion_ver31 for 2 steps: model_final.pth written, the Ver31 step's
   kernels launched.
22. The larger encoder tiers at full width and depth, seeded random weights
   (seed 0), eval_preset, bf16, T = 150 on phase 4's two images:
   vitl336() (CAT-Seg (L), CLIP ViT-L/14@336), vith336() (open_clip
   ViT-H-14) and vitg336() (ViT-bigG-14), one at a time, each freed before
   the next.  Per tier: parameters, seeded-init seconds, device memory
   (utils/profiling.device_memory_stats), the launches of one counted run
   (L: every forward kernel; H and G, head dims 80 and 104: every forward
   kernel but the dense attention, whose gate is the reference's; no
   backward or unfused-stage kernel), shapes and ranges as [4], images/s
   (median of 3).  For vitl336 also the T = 459 batch (PC-459, top-k to
   pad_len 256) and one whole-image predict_argmax (vitl336(), pooling 2x2).
23. fp32 parity of vitl336(compute_dtype="float32"): one whole-image forward
   (probs_whole), 20 classes, GPU kernels against the port on the CPU, max
   |d prob| below 5e-4.
24. The vitl336() train step, as [8]: B = 4, T = 171, pooling 2x2, every
   forward and backward kernel launched, frozen weights bit-equal, 20 timed
   steps.
25. The converter on the card: a seeded vitl336 model's state dict with each
   CLIP attention's q / k / v fused into in_proj_weight, saved as
   {"model": sd} to a temporary .pth, read back by
   weights.convert.load_torch_checkpoint and converted bit-equal to its
   source; then tools.parity_check --config vitl336 --limit 4 on the
   fixture set must exit 0 and launch every forward kernel.
26. The fork's Ver31 dual-encoder family: eval_preset(fusion_ver31()),
   seeded, bf16, T = 150 on phase 4's two images as a sliding Predictor
   batch (RemoteCLIP ViT-B/32 at 768^2 and DINO ViT-B/8 at 384^2 on each of
   the 10 tiles).  Parameters, seeded-init seconds, device memory; one
   counted run launches LayerNorm, dense attention, the Swin pair and the
   class layer and never the corr embed, the decoder (FusionUP is the
   reference's plain composition), a backward or an unfused stage's
   kernel; the class layer's calls carry no text guidance; every kernel
   call of one probs_sliding_batch is held against its plain version on
   its own inputs at [3]'s bound for its dtype;
   probabilities finite in [0, 1]; images/s, median of 3.
27. fp32 parity of fusion_ver31(compute_dtype="float32"): one whole-image
   forward (probs_whole: the padded image resized to 768^2 and, on its own,
   to 384^2), 20 classes, GPU kernels against the port on the CPU, max
   |d prob| below 5e-4.
28. Ver31 at T = 847 (ADE-full): each cost volume its own top-k to pad_len
   256; finite probabilities, the launches, images/s, as [6].
29. The Ver14 SAM refinement family: eval_preset(fusion_ver14()), seeded,
   bf16, T = 150, sliding, proposals from the raw CLIP cost: SAM ViT-B at
   1024^2 on each tile (image by image), the mask decoder over the classes
   one per image a step.  Launches LayerNorm and dense attention, no
   aggregator kernel; memory, init and images/s as [26].  Then one
   whole-image predict_argmax with refine_from="head" launches the corr
   embed, Swin pair, class layer and decoder kernels.  Every kernel call of
   a sliding batch and of the head variant's predict_argmax (LayerNorm at
   768 in CLIP and SAM and at 256 in the fp32 mask decoder) is held against
   its plain version on its own inputs at [3]'s bound for its dtype.  Then fp32 parity of
   one whole-image raw-corr forward at T = 8 against the CPU port, bound
   5e-4 (the mask decoder's weights x5 and the SAM rel-pos tables redrawn,
   so the refined logits are O(1)).
30. The fusion converter on the card: a seeded Ver31 and a seeded Ver14
   model's state dicts (the fork's key names), saved as {"model": sd} to a
   temporary .pth, read back by weights.convert.load_torch_checkpoint and
   converted bit-equal to their sources; then python -m
   catseg_tpu_torch.tools.eval --config fusion_ver31 --limit 2 on the
   fixture set must exit 0.
31. The Ver31 train step: fusion_ver31() at full width and depth (bf16,
   pooling 2x2, DINO and CLIP outside q/v frozen), B = 4, T = 171, as [8]:
   seeded init seconds, one counted warm-up step (#1, #2, #4, #5, #6, #7
   launched; #8, #9 and the unfused stages' never), ms/step over 10 steps
   and the allocator's peak; then one step with every forward and
   backward kernel call recorded, each class layer call (#6, #7) without
   text guidance, and each held against its plain version on its own
   inputs at [3]'s bound; frozen tensors bit-equal, > 90% of the
   trainable ones moved.
32. The Ver14 train step: fusion_ver14() (raw-corr proposals, SAM frozen,
   each of the 43 refinement steps of 16 mask-decoder instances
   recomputed in the backward), the same batch: launches (#1, #2; no
   aggregator kernel), ms/step over 5 steps, peak and init; the SAM
   encoder, the IoU head, the point / not-a-point / no-mask embeddings
   and the Fourier matrix frozen and bit-equal, every tensor of the prompt
   encoder's mask downscaling and of the decoder's transformer moved.
33. [9] for both families at full width: fp32, 1 crop, 8 classes, GPU
   against the port on the CPU (Ver14 at refine_chunk 8 with the mask
   decoder x5); loss within 1e-5 relative, every gradient within 1e-3 of
   max |g_cpu|, frozen weights bit-equal after one update.
34. The SAM tools at SAM ViT-B (1024^2, fp32, seeded, mask decoder x5) on
   tests/torch_fixtures/images/photo_420.jpg: SamPredictor.set_image (must
   launch #1) and predict for a point, a box and a mask prompt (ms,
   medians), the point prompt's low-res logits within 5e-4 of the port on
   the CPU; AutomaticMaskGenerator(points_per_side=32).generate on the
   predictor's canvas (s, median of 3; its record count).
35. The visuals at eval_preset(vitb384()), bf16, T = 150, on the committed
   fixture dataset (tests/torch_fixtures/dataset): evaluate_benchmark with
   dump_visuals=4 and dump_predictions (every forward kernel launched),
   then tools.viz_results on the dumped JSON; every strip written decoded
   by the port's decoder at (H, 3 W, 3) of its GT's size; images/s.
36. tools.demo at vitb384 on two fixture JPEGs: --classes (5 names), then
   --class-json ade150.json sequential and --parallel (AsyncPredictor),
   whose argmax maps must equal the sequential run's; overlays decoded at
   the inputs' shapes; ms an image as the extra time of four inputs over
   two (model build excluded).
37. tools.viz_attn at vitb384, layers 3, 7 and 11, on a fixture JPEG: #1
   launched; the fp32 maps within 1e-5 of the port on the CPU, rows summing
   to 1 within 1e-5; one grey PNG per layer.
38. tools.export at eval_preset(vitb384()), bf16, T = 150, --canvas
   1024x1024 --out-canvas 768x768 --check, into TMPDIR (export s, artifact
   MB, load s; the file deleted after): the loaded artifact bit-equal to
   the live make_serve_fn on a 512x683 image, its run launching the six
   forward kernels; its argmax against Predictor.predict_argmax on a
   480x960 image, whose resizes take dyadic weights (bit-equal CLIP inputs
   on both paths), >= 99% on the pixels the Predictor's top-2 gap decides
   (> 1e-6; ~44% of a random bf16 model's pixels are exact ties, which the
   two resizes' roundings break apart), and on the 512x683 image read only
   (its inputs differ in rounding, which the random bf16 model amplifies);
   an fp32 export at T = 20 agreeing with the CPU port's live serve module
   and with the card's fp32 Predictor on >= 99.9%; the artifact and
   predict_argmax timed (median of 10), nothing claimed.
39. Data parallelism at world size 1 over NCCL (parallel.mesh's process
   group in this process): the data-parallel train step at vitb384() (bf16,
   B = 4, T = 171; one counted step launching every forward and backward
   kernel, 3 timed steps with finite losses; ms/step and images/s beside
   [8]'s one process without a group), then evaluate_sharded over the 4
   fixtures at eval_preset(vitb384()), bf16, T = 150: its int64 matrix
   equal to the one-process harness's, every forward kernel launched.
40. Two ranks sharing cuda:0 over gloo (parallel.mesh.spawn; a check of the
   multi-rank code, not of scaling): an fp32 vitb384 step at global batch 2
   (one crop a rank), 8 classes, against one process stepping the same
   batch (loss within 1e-5, parameters within 1e-4 x max(1, max |p|), the
   ranks bit-equal), then evaluate_sharded over the fixtures in bf16: the
   matrix equal, int64, to [39]'s (one process running the same per-rank
   batches in turn); cells differing from the plain harness's are logged;
   every kernel launched on both ranks; each rank's ms/step.
41. Tile-sharded latency: Predictor(mesh=make_mesh(devices=[cuda:0,
   cuda:0])), two replicas on the one card, fp32, T = 150, on a 480x640
   image: probabilities within atol 2e-5, rtol 1e-4 of the unsharded
   Predictor, the six forward kernels launched; ms an image both ways (one
   card: no scaling read).  Then tools.demo --shard-tiles on one GPU runs
   unsharded and prints its note.
42. The MambaIR VSSBlock (core/mamba.py, d_model 96, d_state 16) on a 2 x 32
   x 32 x 96 input, fp32, weights perturbed from the seeded init: the card
   against the port on the CPU within 1e-5 of max(1, |ref|), its LayerNorms
   on kernel #1; ms a call.
43. Class-axis model parallelism, forward (parallel.class_axis; a check of
   the code, not of scaling): two gloo ranks sharing cuda:0 on the mesh
   {1, 2}, the eval_preset(vitb384()) aggregator at full width on 2 images
   of random CLIP features and guidance, T = 847 (top-k to 256, 128 a rank)
   and T = 150 (75 a rank).  fp32: max |d logit| within 2e-4 of one process
   on the card, equal kept sets.  bf16: one counted forward a rank (the
   corr embed, Swin pair, class layer and decoder launched), every kernel
   call of another held against its plain version at [3]'s bound, ms a
   forward a rank; seconds from spawn to the last result.
44. Class-axis train step: three gloo ranks sharing cuda:0 on the mesh
   {1, 3} at T = 171 (57 classes a rank): an fp32 step at one crop with
   CLIP cut to 8 image and 4 text layers against one process (loss within
   1e-5, parameters within 1e-4 x max(1, max |p|), ranks bit-equal); then
   vitb384() in bf16 at 2 crops: one counted step launching #3-#9, ms/step
   (median of 3) and the allocator's peak a rank.  The same fp32 step on
   [43]'s ranks as the mesh {1, 2}, where 171 does not divide: the warning
   on both ranks and the result of one process.
45. The fusion families on a class axis, in [43]'s and [44]'s ranks. On
   {1, 2}: the eval_preset(fusion_ver31()) forward on 2 random 384^2 tiles
   at T = 847 (each volume its own top-k to 256, 128 a rank) and 150, and
   eval_preset(fusion_ver14()) (raw-corr proposals, the mask decoder x5)
   at 150; fp32 at cut depth within 2e-4 of one process on the card with
   equal kept sets; bf16 at full depth: one counted forward a rank (#1,
   #2, #4, #6 for Ver31; #1, #2 for Ver14), every kernel call of another
   held against its plain version at [3]'s bound, ms a forward a rank.
   On {1, 3} at T = 171: each family's fp32 step at one crop and cut depth
   against one process (loss within 1e-6, parameters within 1e-5, ranks
   bit-equal; the reduced gradients' worst relative error logged), then
   its bf16 step at full depth and 2 crops: one counted step, ms/step
   (median of 3) and the allocator's peak a rank, every forward and
   backward kernel call of another step held against its plain version.
46. vitb384 at hidden 256 (4 heads of 64) served: a Predictor at
   eval_preset(vitb384(hidden_dim=256)), seeded random weights, bf16, on
   phase 4's two images at T = 150.  The Swin and class stages take the
   unfused route (the fused #4 / #6 take C = 128) and the decoder the plain
   composition (the reference's gate wants 128 channels).  One counted
   run: LayerNorm, dense attention, corr embed (C = 256), window attention,
   MLP and linear attention launch, the Swin, class-layer, decoder and
   backward kernels never; shapes and ranges as [4]; every kernel call of
   a second run (#1, #2, #3 at C = 256, #10 at head dim 64, #11 at 256 ->
   1024 -> 256, #12 at C = 256) against its plain version on its own
   inputs as the call is made (selfcheck.checked_calls: no input kept), at
   [3]'s bounds; images/s (median of 3) and the allocator's
   peak.  Then the aggregator alone at full width
   (24x24, E 512, hidden 256, T = 150, one image of random features) in
   fp32 on the card against the port on the CPU, below 5e-4; and the bf16
   gate of [14] at this width (tools/bf16_gate.py, its seed and bounds).
47. vitb384 at one aggregator head of 128 served, as phase 46 (one phase
   function): eval_preset(vitb384(num_heads=1)), hidden 128.  The Swin and
   class stages take the unfused route (the fused #4 / #6 take 4 heads) and
   the decoder its kernel.  One counted run: LayerNorm, dense attention,
   corr embed (C = 128), the decoder, window attention and linear
   attention (head dim 128) and the MLP (128 -> 512 -> 128) launch, the
   Swin, class-layer and backward kernels never; every kernel call of a
   second run against its plain version at [3]'s bounds; images/s and the
   allocator's peak; the aggregator in fp32 at full width (24x24, E 512,
   hidden 128, one head, T = 150) on the card against the CPU, below 5e-4;
   [14]'s gate at this width (bf16_gate.readings(num_heads=1)).
48. vitb384 at hidden 512 (4 heads of 128) served, as phase 46 (the same
   phase function and kernel sets): eval_preset(vitb384(hidden_dim=512)).
   One counted run: LayerNorm, dense attention, corr embed (C = 512),
   window attention and linear attention (head dim 128; window attention
   in bf16 on the CUDA cores, as the window's K and V at 4 heads pass the
   tensor-core path's shared memory) and the MLP (512 -> 2048 -> 512, the
   wide kernel) launch, the Swin, class-layer, decoder and backward
   kernels never; every kernel call of a second run against its plain
   version at [3]'s bounds; images/s and the allocator's peak; the
   aggregator in fp32 at full width (24x24, E 512, hidden 512, T = 150) on
   the card against the CPU, below 5e-4; [14]'s gate at this width
   (bf16_gate.readings(hidden_dim=512)).
49. vitb384 at hidden 384 (4 heads of 96) served, as phase 46 (the same
   phase function and kernel sets): eval_preset(vitb384(hidden_dim=384)).
   One counted run: LayerNorm, dense attention, corr embed (C = 384),
   window attention (head dim 96, bf16 on the tensor cores), the MLP (384
   -> 1536 -> 384, the wide kernel) and linear attention (head dim 96, its
   CUDA-core path) launch, the Swin, class-layer, decoder and backward
   kernels never; every kernel call of a second run against its plain
   version at [3]'s bounds; images/s and the allocator's peak; the
   aggregator in fp32 at full width (hidden 384, T = 150) on the card
   against the CPU, below 5e-4; [14]'s gate at this width.
50. vitb384 at one aggregator head of 256 served, as phase 46:
   eval_preset(vitb384(hidden_dim=256, num_heads=1)).  As [49], with the
   corr embed at C = 256, window and linear attention at head dim 256 (both
   on CUDA cores) and the MLP at 256 -> 1024 -> 256.

Phase [3] also gives each call under 1 ms a device time: 20 calls captured
in one CUDA graph, timed over its replays (no host launch path inside),
rotating over enough copies of the inputs (LayerNorm, dense attention) that
they come from device memory and not from the L2.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a JSON line with one entry
per kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PROB_BOUND = 5e-4   # fp32 GPU-vs-CPU max |d prob| (the README's oracle bound)
STAGE_BOUND = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -5}   # unfused vs fused stage, of max(1, |fused|)
SEED = 0
STEADY_IMAGES = 128   # entries of [19]'s steady-state dataset of 480x640 JPEGs
DECIDED_TIE = 1e-6    # [38]: a top-2 gap at or below it is a tie within fp32 rounding
PARITY_TEXT_LAYERS = 4   # the text tower's depth in the fp32 parity runs (cut_depth)


PHASE_SECONDS = {}   # a phase's number -> seconds from its header to the next one's
_phase = [None, 0.0]


def log(*a):
    """Print a line; a phase's header ("[N] ...") also starts its clock."""
    head = str(a[0]).split(" ", 1)[0] if a else ""
    if head[:1] == "[" and head[1:2].isdigit() and head.endswith("]"):
        phase_clock(head)
    print(*a, flush=True)


def phase_clock(head=None) -> None:
    """Charge the time since the last phase header to that phase and start
    ``head``'s (None: stop)."""
    now = time.perf_counter()
    if _phase[0] is not None:
        PHASE_SECONDS[_phase[0]] = PHASE_SECONDS.get(_phase[0], 0.0) + now - _phase[1]
    _phase[:] = [head, now]


def cut_depth(cfg):
    """A parity run's config: the CLIP image tower cut to just past its last
    guidance tap and the text tower to PARITY_TEXT_LAYERS layers, widths
    unchanged.  The fp32 parity runs check the kernels' arithmetic against
    the CPU port or one process; depth repeats the same layers, and the
    runs at full depth ([4], [8], ...) drive the kernels at full depth."""
    clip = dataclasses.replace(cfg.clip, layers=max(cfg.guidance_layers) + 1,
                               text_layers=min(cfg.clip.text_layers, PARITY_TEXT_LAYERS))
    return dataclasses.replace(cfg, clip=clip)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls.  A call
    under 1 ms is timed as one event pair around 20 back-to-back calls,
    divided by 20: in a single call's window the host's launch time (ctypes,
    argument checks) would land inside a short kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    inner, times = 1, []
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / inner
        if inner == 1 and ms < 1.0:
            inner = 20      # the first reading decides; it is not kept
            continue
        times.append(ms)
    return statistics.median(times)


def graph_ms(fns, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``calls`` back-to-back calls, rotating over
    ``fns`` (one call on different copies of its inputs), captured in one
    CUDA graph; the median of ``reps`` CUDA-event timed replays, divided by
    ``calls``.  A replay enqueues no host work, so this is the time the card
    takes, gaps between the kernels included, without the host's launch
    path (autograd, casts, the ctypes launch)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def rotation(case) -> tuple[list, list]:
    """(kernel thunks, library thunks) over enough copies of a case's inputs
    that one turn moves at least three times the L2's bytes: in a graph
    replay each call then reads its inputs from device memory, as its byte
    bound assumes, not from the L2 the previous call filled."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n = 1 if case.fresh is None else max(1, math.ceil(3 * l2 / case.bytes))
    pairs = [(case.kernel, case.library)] + [case.fresh() for _ in range(n - 1)]
    return [k for k, _ in pairs], [lib for _, lib in pairs]


def check_kernels(dev, dtype, selfcheck, _build) -> dict:
    """Phase 3 for one dtype: {case: {max_abs_err, rel_err (the judged error: a forward output's
    max relative, a backward's worst relative Frobenius), rel_bound, ms, plain_ms, library_ms,
    bound_ms, bound_by}}.  A case whose kernel call does not raise its kernel's launch count
    fails (case "mlp@swin" counts as "mlp")."""
    out, bad = {}, []
    for name, case in selfcheck.cases(dev, dtype).items():
        t_case = time.perf_counter()
        got, counts = run_counted(case.kernel, _build)
        if counts[name.split("@")[0]] == 0:
            bad.append(f"{name} (never launched its kernel)")
        want = case.plain()
        torch.cuda.synchronize()
        err, rel = selfcheck.rel_err(got, want)
        # gradients: the Frobenius error is judged; the max-norm one is read
        worst = " max-norm {:.1e} ({})".format(*selfcheck.max_rel(got, want)) if isinstance(want, dict) else ""
        del got, want
        reps = 3 if name.endswith("_bwd") else 10   # a backward call takes up to a second
        k_ms, p_ms = time_ms(case.kernel, reps, 1), time_ms(case.plain, reps, 1)
        lib_ms = time_ms(case.library) if case.library is not None else None
        # under 1 ms the host's launch path may rival the kernel: device time beside it
        dev_ms = lib_dev_ms = None
        if k_ms < 1.0:
            kerns, libs = rotation(case)
            dev_ms = graph_ms(kerns)
            lib_dev_ms = graph_ms(libs) if case.library is not None else None
            del kerns, libs
        b_ms, b_by = selfcheck.bound_ms(case)
        bound = selfcheck.bound(name, dtype)
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms (kernel / library {k_ms / lib_ms:.2f})"
        dev = "" if dev_ms is None else f"  device (CUDA graph) kernel {dev_ms:.4f} ms" + (
            "" if lib_dev_ms is None else f" library {lib_dev_ms:.4f} ms (kernel / library {dev_ms / lib_dev_ms:.2f})")
        log(f"  {name:16s} {str(dtype)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e}){worst} "
            f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  library {lib}  bound {b_ms:.4f} ms ({b_by}){dev}  "
            f"(case {time.perf_counter() - t_case:.1f} s)")
        if not rel <= bound:
            bad.append(name)
        out[name] = {"max_abs_err": err, "rel_err": rel, "rel_bound": bound, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions, or never launched, in {dtype}: {bad}")
    return out


def run_counted(fn, _build):
    """fn() with every launch count set to 0 just before; returns (result, counts)."""
    torch.cuda.synchronize()
    _build.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(_build.LAUNCHES)


def images_per_s(pred, images, hws, canvas) -> tuple[float, float]:
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.preds_sliding_batch(images, hws, canvas)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    return len(images) / med, med


def check_preds(preds, canvas, n_classes):
    preds = preds.cpu()
    if preds.shape != (2, *canvas) or preds.dtype != torch.int32:
        raise AssertionError(f"preds {tuple(preds.shape)} {preds.dtype}")
    if not ((preds >= 0) & (preds < n_classes)).all() or preds[1, 480:].any() or preds[1, :, 640:].any():
        raise AssertionError(f"labels outside [0, {n_classes}) or outside the image's true size")
    return preds


def check_probs(probs, n_classes):
    if probs.shape != (2, 640, 640, n_classes) or not torch.isfinite(probs.float()).all():
        raise AssertionError(f"probs {tuple(probs.shape)} not finite")
    if probs.min() < 0 or probs.max() > 1:
        raise AssertionError("probabilities outside [0, 1]")


def synthetic_batch(B: int, T: int, seed: int):
    """B uint8 384^2 crops and int64 targets in [0, T) with ~10% ignore (255)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 384, 384, 3), dtype=np.uint8)
    targets = rng.randint(0, T, (B, 384, 384)).astype(np.int64)
    targets[rng.rand(B, 384, 384) < 0.1] = 255
    return torch.from_numpy(images), torch.from_numpy(targets)


TRAIN_STEPS = 10   # timed train steps after the warm-up, [8], [12] and [24]
STEP_MS: dict = {}   # config -> median ms/step of its train_step_phase ([39] reads [8]'s)


def train_step_phase(dev, smi, _build, cfg, expect, absent, steps: int = TRAIN_STEPS, check_calls=None,
                     must_move=None, must_freeze=None) -> dict:
    """Phases 8, 12, 24, 31 and 32: the seeded train state (timed), one
    counted step (every kernel in ``expect`` launched, none in ``absent``),
    ``steps`` timed steps and the allocator's peak over them; with
    ``check_calls`` one more step whose every kernel call, forward and
    backward, goes to ``check_calls(calls)``.  Frozen parameters stay
    bit-equal (every one ``must_freeze(name)`` picks must be frozen); more
    than 90% of the trainable ones move, or every one ``must_move(name)``
    picks.  Returns the counted step's launches."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.kernels import selfcheck
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    names = class_names("coco")
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, opt = state.model, state.optimizer
    step = make_train_step(cfg, opt, class_tokens(names))
    images, targets = (t.to(dev) for t in synthetic_batch(4, len(names), SEED))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    loss, counts = run_counted(lambda: step(model, images, targets), _build)
    log(f"    warm-up step: loss {loss.item():.6f}, launches {counts}")
    if not torch.isfinite(loss) or min(counts[k] for k in expect) == 0 or any(counts[k] for k in absent):
        raise AssertionError("train step: non-finite loss, a kernel of the path never launched, or one "
                             f"of {absent} did")
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, images, targets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    STEP_MS[cfg] = ms
    log(f"    {ms:.1f} ms/step median, min {min(times):.1f}, max {max(times):.1f} ({steps} steps after the "
        f"warm-up), {4e3 / ms:.3f} images/s on {smi}; last loss {loss.item():.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; seeded init + copy to the card {init_s:.1f} s")
    if check_calls is not None:
        with selfcheck.recorded_calls(backward=True) as calls:
            step(model, images, targets)
        check_calls(calls)
        del calls
    frozen = [n for n, lbl in opt.labels.items() if lbl == "frozen"]
    trainable = [n for n, lbl in opt.labels.items() if lbl != "frozen"]
    params = dict(model.named_parameters())
    changed = [n for n in frozen if not torch.equal(params[n], start[n])]
    moved = {n for n in trainable if not torch.equal(params[n], start[n])}
    log(f"    {len(frozen)} frozen tensors, {len(changed)} changed; {len(moved)} of {len(trainable)} trainable moved")
    if changed or (must_move is None and len(moved) <= 0.9 * len(trainable)):
        raise AssertionError(f"train step: frozen changed {changed[:5]} or too few trainables moved")
    if must_move is not None:
        need = [n for n in trainable if must_move(n)]
        log(f"    {len(need)} trainable tensors that must move: {len(moved.intersection(need))} moved")
        if not need or not moved.issuperset(need):
            raise AssertionError(f"train step: these did not move: {sorted(set(need) - moved)[:5]}")
    if must_freeze is not None:
        need = [n for n in params if must_freeze(n)]
        log(f"    {len(need)} tensors that must stay frozen: all frozen and bit-equal "
            f"{bool(need) and set(need) <= set(frozen)}")
        if not need or not set(need) <= set(frozen):
            raise AssertionError(f"train step: these are not frozen: {sorted(set(need) - set(frozen))[:5]}")
    del state, model, opt, start, params
    torch.cuda.empty_cache()
    return counts


def zero_by_symmetry(name: str) -> bool:
    """An attention k bias, whose gradient is zero by symmetry (softmax
    ignores a per-query constant): both sides of a comparison hold rounding
    noise there."""
    return ((".swin_block." in name and name.endswith(".attn.k.bias"))
            or (name.startswith("sam_decoder.") and name.endswith(".k_proj.bias")))


def train_parity_phase(dev, cfg=None, prepare=None) -> None:
    """Phases 9 and 33: an fp32 step on the card (kernels) against the port on
    the CPU, of ``cfg`` (default ``vitb384(compute_dtype="float32")``); the
    seeded model goes through ``prepare(model)`` first, where given."""
    from catseg_tpu_torch.configs import class_names, vitb384
    from catseg_tpu_torch.core.clip import truncate_context
    from catseg_tpu_torch.train.loop import TrainState, class_tokens, init_train_state, train_loss
    from catseg_tpu_torch.train.optim import TrainOptimizer

    if cfg is None:
        log("[9] fp32 train-step parity: vitb384(compute_dtype='float32'), CLIP cut (cut_depth), 1 crop, 8 classes, "
            "GPU vs CPU")
        cfg = cut_depth(vitb384(compute_dtype="float32"))
    cpu = init_train_state(cfg, seed=SEED, device="cpu")
    if prepare is not None:
        prepare(cpu.model)
    gpu_model = copy.deepcopy(cpu.model).to(dev)
    gpu = TrainState(model=gpu_model, optimizer=TrainOptimizer(cfg, gpu_model))
    tokens = torch.from_numpy(truncate_context(class_tokens(class_names("coco")[:8])).astype(np.int64))
    images, targets = synthetic_batch(1, 8, SEED + 3)
    start = {n: p.detach().clone() for n, p in cpu.model.named_parameters()}
    loss_g = train_loss(cfg, gpu.model, tokens.to(dev), images.to(dev), targets.to(dev))
    loss_g.backward()
    loss_c = train_loss(cfg, cpu.model, tokens, images, targets)
    loss_c.backward()
    d_loss = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    worst, worst_name, unused, zero, symmetric = 0.0, None, [], [], 0.0
    gp = dict(gpu.model.named_parameters())
    for n, p in cpu.model.named_parameters():
        if not p.requires_grad:
            continue
        g_cpu, g_gpu = p.grad, gp[n].grad
        if g_cpu is None and g_gpu is None:
            unused.append(n)   # the last visual block's q / k: its dense output uses only v
            continue
        if g_cpu is None or g_gpu is None:
            raise AssertionError(f"no gradient for {n} on the {'CPU' if g_cpu is None else 'GPU'}")
        if not g_cpu.any() and not g_gpu.any():
            zero.append(n)     # Ver14's hypernetwork MLPs of the mask tokens a single-mask output drops
            continue
        if zero_by_symmetry(n):
            symmetric = max(symmetric, g_cpu.abs().max().item(), g_gpu.abs().max().item())
            continue
        r = (g_gpu.cpu() - g_cpu).abs().max().item() / max(g_cpu.abs().max().item(), 1e-30)
        if r > worst:
            worst, worst_name = r, n
    log(f"    loss GPU {loss_g.item():.8f} CPU {loss_c.item():.8f} (rel {d_loss:.2e}, bound 1e-5); "
        f"worst gradient max|d|/max|g_cpu| {worst:.2e} at {worst_name} (bound 1e-3); "
        f"no gradient on either side: {len(unused)} tensors {unused[:4]}; a zero gradient on both: {len(zero)} "
        f"{zero[:2]}; attention k-bias gradients (zero by symmetry) at most {symmetric:.1e}")
    gpu.optimizer.step()
    cpu.optimizer.step()
    upd, frozen_ok, moved, n_train = 0.0, True, 0, 0
    for n, p in cpu.model.named_parameters():
        q = gp[n].detach().cpu()
        if cpu.optimizer.labels[n] == "frozen":
            frozen_ok &= torch.equal(p, start[n]) and torch.equal(q, start[n])
            continue
        if n in unused or n in zero:
            continue
        n_train += 1
        moved += int(not torch.equal(p, start[n]) and not torch.equal(q, start[n]))
        upd = max(upd, ((q - start[n]) - (p.detach() - start[n])).abs().max().item())
    log(f"    after one update: frozen equal {frozen_ok}, {moved} of {n_train} trainables with a nonzero gradient "
        f"moved on both, largest update difference {upd:.3e}")
    if not d_loss <= 1e-5 or not worst <= 1e-3 or not frozen_ok or moved <= 0.9 * n_train:
        raise AssertionError("fp32 train step on the GPU disagrees with the CPU port")
    del cpu, gpu, gpu_model
    torch.cuda.empty_cache()


def full_attention_serving_phase(dev, smi, _build, images, hws, canvas, names):
    """Phase 10; returns the counted run's launches and the model's aggregator."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[10] sliding-window Predictor, eval_preset(vitb384(attention_type='full')), bf16, T=150")
    cfg = eval_preset(vitb384(attention_type="full"))
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    if (launches["mlp"] == 0 or launches["class_layer"] or launches["window_attention"]
            or launches["linear_attention"] or not all(launches[k] for k in ("swin_block", "decoder"))):
        raise AssertionError("full attention: the class MLP kernel never launched, or the route is wrong")
    check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s with full class attention (median of 3 2-image runs, {med * 1e3:.1f} ms) on "
        f"{smi}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    agg = pred.model.agg
    del pred
    torch.cuda.empty_cache()
    return launches, agg


def full_parity_phase(images, names) -> None:
    """Phase 11: fp32 full-attention slice on the card against the CPU port."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[11] fp32 parity with attention_type='full': GPU kernels vs the port on the CPU, 1 image, 20 classes, CLIP "
        "cut (cut_depth)")
    cfg = cut_depth(eval_preset(vitb384(compute_dtype="float32", attention_type="full")))
    cpu_model = init_catseg_(CATSeg(cfg), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg, names[:20])
    p_gpu = gpu_pred.probs_sliding_batch(images[1:]).cpu()
    p_cpu = Predictor(cpu_model, cfg, names[:20], device="cpu").probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    log(f"    max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 full-attention slice on the GPU disagrees with the CPU port")
    del gpu_pred, cpu_model
    torch.cuda.empty_cache()


def stage_phase(dev, agg, _build) -> dict:
    """Phase 13: the unfused stages against the fused kernels at full width;
    returns the launches of the bf16 unfused runs."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core import aggregator as A
    from catseg_tpu_torch.kernels import selfcheck

    log("[13] unfused stages vs the fused kernels: Swin pair on (10, 150, 24, 24, 128) with guidance; "
        "linear class stage at T=150 (pad 256, pooling 1x1) and (4, 171) pooling 2x2")
    serve, train = eval_preset(vitb384()), vitb384()
    layer = agg.layers[0]
    g = torch.Generator().manual_seed(SEED + 4)
    xs, gs = torch.randn(10, 150, 24, 24, 128, generator=g), torch.randn(10, 24, 24, 128, generator=g) * 0.5
    ts = torch.relu(torch.randn(10, 150, 128, generator=g)) * 0.3
    xt, tt = torch.randn(4, 171, 24, 24, 128, generator=g), torch.relu(torch.randn(4, 171, 128, generator=g)) * 0.3
    total = dict.fromkeys(_build.UNFUSED, 0)
    bad = []
    for dt in (torch.float32, torch.bfloat16):
        x, ag, tg, x2, tg2 = (t.to(dev, dt) for t in (xs, gs, ts, xt, tt))
        stages = {
            "swin pair": (lambda: A.spatial_aggregation(x, ag, layer, serve),
                          lambda: A.swin_pair_unfused(x, ag, layer, serve), ("window_attention", "mlp")),
            "class T=150 1x1": (lambda: A.class_aggregation(x, tg, layer, serve),
                                lambda: A.class_layer_unfused(x, tg, layer, serve), ("linear_attention", "mlp")),
            "class T=171 2x2": (lambda: A.class_aggregation(x2, tg2, layer, train),
                                lambda: A.class_layer_unfused(x2, tg2, layer, train), ("linear_attention", "mlp")),
        }
        with torch.no_grad():
            for name, (fused, unfused, kernels) in stages.items():
                want = fused()
                got, counts = run_counted(unfused, _build)
                err, rel = selfcheck.rel_err(got, want)
                del got, want
                ms_f, ms_u = time_ms(fused, 3, 1), time_ms(unfused, 3, 1)
                log(f"    {name:16s} {str(dt)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} "
                    f"(bound {STAGE_BOUND[dt]:.1e})  fused {ms_f:.3f} ms  unfused {ms_u:.3f} ms  "
                    f"launches {({k: counts[k] for k in _build.UNFUSED})}")
                if not rel <= STAGE_BOUND[dt] or min(counts[k] for k in kernels) == 0:
                    bad.append((name, str(dt)))
                if dt == torch.bfloat16:
                    for k in _build.UNFUSED:
                        total[k] += counts[k]
                torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"unfused stages disagree with the fused kernels or skipped a kernel: {bad}")
    return total


WHOLE_RUNS = 20   # timed 2-image runs of [15]


def whole_image_phase(smi, _build, images, names) -> dict:
    """Phase 15; returns the counted run's launches."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    log("[15] single-image API, whole-image branch: Predictor(vitb384()) (bf16, pooling 2x2), T=150, predict_argmax")
    cfg = vitb384()
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)

    def run():
        return [pred.predict_argmax(im) for im in images]

    run()                                                  # warm-up (cuDNN plans)
    labels, launches = run_counted(run, _build)
    log(f"    launches in one 2-image run: {launches}")
    missing = [k for k in _build.FORWARD if launches[k] == 0]
    if missing or any(launches[k] for k in _build.BACKWARD + _build.UNFUSED):
        raise AssertionError(f"the whole-image path never launched {missing}, or launched a backward or an "
                             "unfused stage's kernel")
    for im, lab in zip(images, labels):
        if lab.shape != im.shape[:2] or lab.dtype != np.int32 or lab.min() < 0 or lab.max() >= len(names):
            raise AssertionError(f"labels {lab.shape} {lab.dtype} in [{lab.min()}, {lab.max()}]")
    # each forward kernel on the very inputs this path hands it (class layer
    # on the 12x12 pooled grid outside autograd, the decoder at 150 slabs)
    with selfcheck.recorded_calls() as calls:
        probs = pred.probs_whole(images[0])
    shapes = {}
    for name, args in calls:
        shapes.setdefault(name, tuple(args[0].shape))
    errs = selfcheck.check_calls(calls, torch.bfloat16)
    bad = sorted(set(_build.FORWARD) - set(errs))
    for name, (n, err, rel) in errs.items():
        bound = selfcheck.bound(name, torch.bfloat16)
        log(f"    {name:16s} bf16 {n:2d} calls of this path, first input {shapes[name]}: max_abs_err {err:.3e} "
            f"rel {rel:.3e} (bound {bound:.1e})")
        if not rel <= bound:
            bad.append(name)
    del calls
    if bad:
        raise AssertionError(f"on the whole-image path's own inputs these kernels disagree with their plain "
                             f"versions, or were never called: {bad}")
    if probs.shape != (96, 96, len(names)) or probs.dtype != torch.float32 or not (
            (probs >= 0) & (probs <= 1)).all():
        raise AssertionError(f"whole-image probs {tuple(probs.shape)} {probs.dtype} outside [0, 1]")
    secs = []
    for _ in range(WHOLE_RUNS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    log(f"    {len(images) / med:.3f} images/s on the whole-image branch at the median of {WHOLE_RUNS} 2-image "
        f"runs ({med * 1e3:.1f} ms; min {min(secs) * 1e3:.1f} ms = {len(images) / min(secs):.3f} images/s, max "
        f"{max(secs) * 1e3:.1f} ms = {len(images) / max(secs):.3f} images/s) on {smi}; labels "
        f"{[lab.shape for lab in labels]} in [{min(lab.min() for lab in labels)}, {max(lab.max() for lab in labels)}], "
        f"{len(np.unique(np.concatenate([lab.ravel() for lab in labels])))} distinct")
    del pred
    torch.cuda.empty_cache()
    return launches


def single_image_parity_phase(_build, image, names, cpu_model, p_cpu_sliding) -> None:
    """Phase 16: the single-image API in fp32 on the card against the CPU
    port; ``cpu_model`` and its sliding probabilities come from phase 5."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[16] fp32 parity of the single-image API: vitb384(compute_dtype='float32'), CLIP cut (cut_depth), 1 image, "
        "20 classes, GPU vs CPU")
    cfg = cut_depth(vitb384(compute_dtype="float32"))
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    cpu = Predictor(cpu_model, cfg, names, device="cpu")
    p_gpu, launches = run_counted(lambda: gpu.probs_whole(image).cpu(), _build)
    p_cpu = cpu.probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    agree = (gpu.predict_argmax(image) == cpu.predict_argmax(image)).mean()
    gpu_s = Predictor(gpu.model, eval_preset(cfg), names)
    s_gpu = gpu_s.probs_sliding(image)
    row_equal = torch.equal(s_gpu, gpu_s.probs_sliding_batch([image])[0])
    ds = (s_gpu.cpu() - p_cpu_sliding).abs()
    log(f"    probs_whole max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}  "
        f"launches {launches}")
    log(f"    predict_argmax agreement {agree:.5f} (bound 0.999); probs_sliding (eval_preset) max|d prob| "
        f"{ds.max().item():.3e} (bound {PROB_BOUND:.0e}) mean {ds.mean().item():.3e}; equal to the batch row {row_equal}")
    if (not d.max().item() < PROB_BOUND or not agree >= 0.999 or not ds.max().item() < PROB_BOUND or not row_equal
            or min(launches[k] for k in _build.FORWARD) == 0):
        raise AssertionError("the fp32 single-image API on the GPU disagrees with the CPU port, or skipped a kernel")
    del gpu, gpu_s
    torch.cuda.empty_cache()


def routes_phase(dev, _build) -> None:
    """Phase 17: the aggregator at geometries some kernels do not take."""
    from catseg_tpu_torch.core.aggregator import aggregator_forward
    from catseg_tpu_torch.kernels import selfcheck

    log("[17] aggregator routes outside some kernels' limits: fp32, T=8, GPU vs CPU, or the card's refusal")
    bad = []
    for name, route in selfcheck.ROUTES.items():
        called, raises, plain = route[-3:]
        cfg, agg, (img, txt, guid) = selfcheck.route_aggregator(name)
        head = f"    {name:20s} (hidden {cfg.hidden_dim}, {cfg.num_heads} heads, E {img.shape[-1]}):"
        with torch.no_grad():
            want = torch.sigmoid(aggregator_forward(agg, img, txt, guid, cfg))
            agg.to(dev)
            try:
                got, launches = run_counted(lambda: torch.sigmoid(aggregator_forward(
                    agg, img.to(dev), txt.to(dev), tuple(g.to(dev) for g in guid), cfg)).cpu(), _build)
            except NotImplementedError as e:
                log(f"{head} raised, as {sorted(raises)} raise there: {e}")
                if not any(k.replace("_", " ") in str(e) for k in raises):
                    bad.append(name)
                continue
        d = (got - want).abs().max().item()
        launched = {k for k, n in launches.items() if n}
        log(f"{head} max|d prob| {d:.3e} (bound {PROB_BOUND:.0e})  launched {sorted(launched)}"
            + (f", {sorted(plain)} plain as the reference's gates say" if plain else ""))
        if raises or not d < PROB_BOUND or launched - {"layer_norm"} != called - plain:
            bad.append(name)
    if bad:
        raise AssertionError(f"aggregator routes disagree with the CPU, launched the wrong kernels, or did not "
                             f"raise where ROUTES says the card raises: {bad}")


def bf16_gate_phase(_build) -> None:
    """Phase 14: the bf16 serving path against fp32 on the card, held to the
    reference's own bounds for its production dtype (tools/bf16_gate.py)."""
    from catseg_tpu_torch.tools import bf16_gate as gate

    log(f"[14] bf16 vs fp32 end to end: eval_preset(vitb384(compute_dtype=dt)), seed {gate.GATE_SEED}, T=150 "
        "random unit text features, one 427x640 image")
    r = gate.readings()
    log(f"    max|d prob| {r['max_abs_dprob']:.4e} (bound {gate.BOUND_MAX:.0e})  mean {r['mean_abs_dprob']:.4e} "
        f"(bound {gate.BOUND_MEAN:.0e})  argmax agreement {r['decided_agreement']:.5f} on {r['decided_pixels']} of "
        f"{r['pixels']} pixels whose fp32 top-2 gap exceeds {gate.DECIDED_GAP} (bound {gate.BOUND_AGREE}; all "
        f"pixels {r['all_agreement']:.5f})  bf16 launches {r['bf16_launches']}")
    missing = [k for k in _build.FORWARD if r["bf16_launches"][k] == 0]
    if not r["ok"] or missing:
        raise AssertionError(f"bf16 serving drifts past the reference's bounds from fp32, or never launched {missing}")


# [46] / [48]-[50]: the kernels vitb384 at hidden 256 / 512 / 384 (and 256 at
# one head) serves through, and those it never launches (fused #4 / #6 take
# C = 128; the decoder's gate wants 128 channels)
WIDE_KERNELS = ("layer_norm", "dense_attention", "corr_embed", "window_attention", "mlp", "linear_attention")
WIDE_ABSENT = ("swin_block", "class_layer", "decoder", "swin_block_bwd", "class_layer_bwd", "decoder_bwd")
# [47]: those of vitb384 at one aggregator head (hidden 128): the fused #4 /
# #6 take 4 heads, so the Swin and class stages take the unfused route; the
# decoder takes hidden 128
HEADS1_KERNELS = ("layer_norm", "dense_attention", "corr_embed", "decoder", "window_attention", "mlp",
                  "linear_attention")
HEADS1_ABSENT = ("swin_block", "class_layer", "swin_block_bwd", "class_layer_bwd", "decoder_bwd")


def variant_serving_phase(dev, smi, _build, images, hws, canvas, names, tag: str, arch: dict, heads: str,
                          label: str, width: str, expect, absent) -> dict:
    """Phases 46-50: ``eval_preset(vitb384(**arch))`` served on the card
    (``heads`` says its aggregator heads, ``label`` names the variant in the
    log, ``width`` the aggregator's in the fp32 line); ``expect`` launch and
    ``absent`` never.
    Returns the launches of its counted run."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.aggregator import aggregator_forward
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck, window_attn
    from catseg_tpu_torch.tools import bf16_gate as gate

    t_phase = time.perf_counter()
    keys = ", ".join(f"{k}={v}" for k, v in arch.items())
    log(f"{tag} sliding-window Predictor, eval_preset(vitb384({keys})) ({heads}), bf16, T={len(names)}")
    cfg = eval_preset(vitb384(**arch))
    N = cfg.window_size ** 2
    on_tc = window_attn.takes_tensor_cores(N, cfg.hidden_dim, cfg.num_heads, torch.bfloat16)
    log(f"    window attention at {N} tokens, head dim {cfg.hidden_dim // cfg.num_heads}: bf16 on the "
        f"{'tensor' if on_tc else 'CUDA'} cores")
    torch.cuda.reset_peak_memory_stats()
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    check_launches(launches, expect, absent, f"{tag} {label} serving")
    preds = check_preds(preds, canvas, len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms), allocator peak {peak:.2f} GiB, "
        f"on {smi}; {len(np.unique(preds.numpy()))} distinct labels")
    # each kernel on the very inputs this path hands it, checked as it is
    # called (hidden 512's calls' inputs would not fit on the card together)
    with selfcheck.checked_calls() as checked:
        probs = pred.probs_sliding_batch(images)
    check_probs(probs, len(names))
    del probs
    check_path_calls(checked, f"{tag} {label} sliding", expect)
    del pred
    torch.cuda.empty_cache()

    cfg32 = cut_depth(eval_preset(vitb384(compute_dtype="float32", **arch)))
    agg = init_catseg_(CATSeg(cfg32), SEED).agg.eval()
    g = torch.Generator().manual_seed(SEED)
    T, E = len(names), cfg32.text_guidance_dim
    img, txt = torch.randn(1, 24, 24, E, generator=g), torch.randn(1, T, 1, E, generator=g)
    d1, d2 = cfg32.decoder_guidance_dims
    guid = (torch.randn(1, 24, 24, cfg32.appearance_guidance_dim, generator=g),
            torch.randn(1, 48, 48, d1, generator=g), torch.randn(1, 96, 96, d2, generator=g))
    with torch.no_grad():
        want = torch.sigmoid(aggregator_forward(agg, img, txt, guid, cfg32))
        agg.to(dev)
        got, agg_launches = run_counted(lambda: torch.sigmoid(aggregator_forward(
            agg, img.to(dev), txt.to(dev), tuple(t.to(dev) for t in guid), cfg32)).cpu(), _build)
    d = (got - want).abs().max().item()
    log(f"    fp32 aggregator at full width (24x24, E {E}, {width}, T={T}, one image), GPU vs the port on the "
        f"CPU: max|d prob| {d:.3e} (bound {PROB_BOUND:.0e}); launches {agg_launches}")
    hyphened = label.replace(" ", "-")
    if not d < PROB_BOUND:
        raise AssertionError(f"{tag} the fp32 {hyphened} aggregator on the GPU disagrees with the CPU port")
    check_launches(agg_launches, [k for k in expect if k != "dense_attention"], absent,
                   f"{tag} fp32 {hyphened} aggregator")
    del agg
    torch.cuda.empty_cache()

    r = gate.readings(**arch)
    log(f"    bf16 vs fp32 end to end ([14]'s gate, seed {r['seed']}): max|d prob| {r['max_abs_dprob']:.4e} (bound "
        f"{gate.BOUND_MAX:.0e})  mean {r['mean_abs_dprob']:.4e} (bound {gate.BOUND_MEAN:.0e})  argmax agreement "
        f"{r['decided_agreement']:.5f} on {r['decided_pixels']} of {r['pixels']} pixels whose fp32 top-2 gap exceeds "
        f"{gate.DECIDED_GAP} (bound {gate.BOUND_AGREE}; all pixels {r['all_agreement']:.5f})  bf16 launches "
        f"{r['bf16_launches']}")
    if not r["ok"]:
        raise AssertionError(f"{tag} bf16 serving at {label} drifts past the reference's bounds from fp32")
    check_launches(r["bf16_launches"], expect, absent, f"{tag} bf16 gate run")
    log(f"    {tag} took {time.perf_counter() - t_phase:.1f} s")
    return launches




FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def photo_dataset(tmp: str, n: int) -> str:
    """An ADE-150-layout dataset of n entries under tmp, each the committed
    480x640 4:2:0 JPEG beside one 480x640 PNG label map (classes in
    [0, 150), a band of 255): inputs of a real dataset's size, enough of them
    for a steady rate."""
    from catseg_tpu_torch.data import loader
    from catseg_tpu_torch.data.image_write import save_image

    root = Path(tmp)
    img_dir = root / "ADEChallengeData2016/images/validation"
    gt_dir = root / "ADEChallengeData2016/annotations_detectron2/validation"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    y, x = np.mgrid[0:480, 0:640]
    gt = (y // 24 * 11 + x // 40) % 150
    gt[200:232] = 255
    save_image(root / "gt.png", gt.astype(np.uint8))
    if not np.array_equal(loader.load_gt(str(root / "gt.png")), gt):
        raise AssertionError("the steady-state label map does not read back")
    for i in range(n):
        (img_dir / f"photo_{i:04d}.jpg").symlink_to(FIXTURES / "images/photo_420.jpg")
        (gt_dir / f"photo_{i:04d}.png").symlink_to(root / "gt.png")
    return str(root)


def predictor_ips(pred, items, canvas, batch: int = 2, passes: int = 3) -> float:
    """images/s of Predictor.preds_sliding_batch alone over loaded (image, gt)
    items, ``batch`` at a time as the harness feeds it: median of passes."""
    secs = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            pred.preds_sliding_batch([im for im, _ in chunk], np.array([g.shape for _, g in chunk], np.int32), canvas)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return len(items) / statistics.median(secs)


def host_data_phase(smi) -> dict:
    """Phase 18: the host library built here, every committed fixture
    decoded and resized to its digest; decode and resize times."""
    from catseg_tpu_torch.data import image_io, loader, resize

    t0 = time.perf_counter()
    lib = image_io.build_host()
    log(f"[18] host data: library built in {time.perf_counter() - t0:.2f} s -> {lib}")
    digests = json.loads((FIXTURES / "digests.json").read_text())
    bad = []
    for rel, want in digests["files"].items():
        p = str(FIXTURES / rel)
        if sha256(loader.load_image(p)) != want["rgb"] or sha256(loader.load_gt(p)) != want["gt"]:
            bad.append(rel)
    rel, (short, max_size) = digests["resize"]["file"], digests["resize"]["short_max"]
    img = loader.load_image(str(FIXTURES / rel))
    resized = loader.resize_shortest_edge(img, short, max_size)
    if sha256(resized) != digests["resize"]["sha256"]:
        bad.append(f"resize_shortest_edge({rel}, {short}, {max_size})")
    if not np.array_equal(resize.resize_bilinear_u8_numpy(img, resized.shape[:2]), resized):
        bad.append("C++ resize != its numpy specification")

    def med_ms(fn, n=10):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e3

    r = {"decode_ms": med_ms(lambda: loader.load_image(str(FIXTURES / rel))),
         "resize_ms": med_ms(lambda: loader.resize_shortest_edge(img, short, max_size)),
         "resize_numpy_ms": med_ms(lambda: resize.resize_bilinear_u8_numpy(img, resized.shape[:2]), 3)}
    log(f"    {len(digests['files'])} fixtures + 1 resize against their digests: "
        f"{'all equal' if not bad else 'MISMATCH ' + str(bad)}")
    log(f"    {rel} ({img.shape[0]}x{img.shape[1]}): decode {r['decode_ms']:.3f} ms, resize to "
        f"{resized.shape[0]}x{resized.shape[1]} {r['resize_ms']:.3f} ms (numpy specification "
        f"{r['resize_numpy_ms']:.3f} ms), median of 10 (3), host CPU; card {smi}")
    if bad:
        raise AssertionError(f"the port's decode / resize differs from the committed digests: {bad}")
    return r


def eval_cli_phase(smi, _build, ips_predictor) -> None:
    """Phase 19: tools.eval on the committed 4-image ADE-150 fixture set; then
    the harness's steady rate over STEADY_IMAGES 480x640 JPEGs beside the
    Predictor alone on the same loaded inputs."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.data import catalogs, loader
    from catseg_tpu_torch.evaluation import harness
    from catseg_tpu_torch.evaluation.miou import ConfusionAccumulator
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.tools import eval as eval_cli

    root = str(FIXTURES / "dataset")
    log("[19] tools.eval on the fixture dataset (4 images, ADE-150 layout): vitb384, eval preset, bf16, T=150")
    runs = {}
    for b in (2, 1):
        runs[b], launches = run_counted(lambda: eval_cli.main(
            ["--config", "vitb384", "--benchmarks", "ade150", "--data-root", root, "--eval-batch", str(b)])["ade150"],
            _build)
        log(f"    --eval-batch {b}: launches {launches}")
        missing = [k for k in _build.FORWARD if launches[k] == 0]
        if missing:
            raise AssertionError(f"tools.eval never launched {missing}")
    m1, m2 = runs[1], runs[2]
    if m2["num_images"] != 4 or not all(np.isfinite(m2[k]) for k in ("mIoU", "fwIoU", "mACC", "pACC")):
        raise AssertionError(f"tools.eval: {m2['num_images']} images, metrics {m2}")
    same = np.array_equal(m1["_conf"], m2["_conf"]) and all(m1[k] == m2[k] for k in ("mIoU", "fwIoU", "mACC", "pACC"))

    cfg = eval_preset(vitb384())
    spec = catalogs.get_dataset("ade150")
    items, canvas, _ = fixture_eval_items(cfg)
    model = build_catseg(cfg, seed=SEED)
    pred = Predictor(model, cfg, class_names("ade150"))
    acc = ConfusionAccumulator(spec.num_classes, spec.ignore_label)
    for i in range(0, len(items), 2):
        chunk = items[i:i + 2]
        hws = np.array([g.shape for _, g in chunk], np.int32)
        preds = pred.preds_sliding_batch([im for im, _ in chunk], hws, canvas)
        gts = torch.full((len(chunk), *canvas), spec.ignore_label, dtype=torch.int32, device=preds.device)
        for j, (_, g) in enumerate(chunk):
            gts[j, :g.shape[0], :g.shape[1]] = torch.from_numpy(g).to(preds.device)
        acc.update(preds, gts)
    direct = np.array_equal(acc.matrix(), m2["_conf"])
    log(f"    mIoU {m2['mIoU']:.4f} fwIoU {m2['fwIoU']:.4f} mACC {m2['mACC']:.4f} pACC {m2['pACC']:.4f} "
        f"(random weights); batch 2 == batch 1 {same}; confusion matrix == Predictor.preds_sliding_batch's {direct}")
    if not same or not direct:
        raise AssertionError("tools.eval's batch 1 and batch 2 differ, or its confusion matrix is not the "
                             "Predictor's")

    ips = sorted(harness.evaluate_benchmark(model, cfg, "ade150", root=root, verbose=False)["images_per_sec"]
                 for _ in range(3))[1]
    log(f"    4 images: harness {ips:.3f} images/s, decode and resize included (median of 3 passes); the Predictor "
        f"alone on the same loaded inputs {predictor_ips(pred, items, canvas):.3f} images/s; [4]'s Predictor "
        f"{ips_predictor:.3f} images/s; on {smi}")

    # the steady state: the 4-image rate above is mostly the pipeline's fill
    def load(pair):   # the harness's own load
        return (loader.resize_shortest_edge(loader.load_image(pair[0]), cfg.min_size_test, cfg.max_size_test),
                loader.load_gt(pair[1]))

    with tempfile.TemporaryDirectory() as tmp:
        big = photo_dataset(tmp, STEADY_IMAGES)
        pairs = loader.list_dataset(spec, root=big)
        t = time.perf_counter()
        items = [load(pair) for pair in pairs]
        load_ms = (time.perf_counter() - t) * 1e3 / len(pairs)
        steady = [harness.evaluate_benchmark(model, cfg, "ade150", root=big, verbose=False) for _ in range(3)]
        if any(r["num_images"] != STEADY_IMAGES or not np.isfinite(r["mIoU"]) for r in steady):
            raise AssertionError(f"the harness over {STEADY_IMAGES} images: {[r['num_images'] for r in steady]}")
        ips = sorted(r["images_per_sec"] for r in steady)[1]
        alone = predictor_ips(pred, items, harness._canvas([g.shape for _, g in items]))
    log(f"    {STEADY_IMAGES} images ({items[0][0].shape[0]}x{items[0][0].shape[1]} after the resize of a 480x640 "
        f"JPEG): harness {ips:.3f} images/s (median of 3 passes), the Predictor alone on the same loaded inputs "
        f"{alone:.3f} images/s, gap {100 * (1 - ips / alone):.1f}%; the harness's load (decode, resize, GT) "
        f"{load_ms:.3f} ms an image in one thread, the Predictor {1e3 / alone:.3f} ms an image; on {smi}")


def tta_phase(smi, _build, names) -> None:
    """Phase 20: TTAPredictor, D2's 9 scales x hflip, and its fp32 parity."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.data import loader
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.infer.tta import TTAPredictor

    image = loader.load_image(str(FIXTURES / "images/photo_420.jpg"))
    log(f"[20] TTAPredictor, D2's 9 scales (400..1200, max 4000) x hflip, on one {image.shape[0]}x{image.shape[1]} "
        "fixture image: vitb384 eval preset, bf16, T=150")
    cfg = eval_preset(vitb384())
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    passes = []
    real = pred.probs_sliding_batch
    pred.probs_sliding_batch = lambda images: (passes.append(len(images)), real(images))[1]
    tta = TTAPredictor(pred)
    tta.probs(image)
    torch.cuda.synchronize()
    passes.clear()
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        (p, launches) = run_counted(lambda: tta.probs(image), _build)
        secs.append(time.perf_counter() - t)
    ok = (p.shape == (640, 640, len(names)) and bool(torch.isfinite(p.float()).all())
          and 0 <= p.min().item() and p.max().item() <= 1)
    log(f"    {sum(passes) // 3} passes an image in {len(passes) // 3} calls; probs {tuple(p.shape)} finite in [0, 1] "
        f"{ok}; {statistics.median(secs) * 1e3:.1f} ms an image (median of 3, resizes included) on {smi}; "
        f"launches {launches}")
    if sum(passes) != 3 * 18 or not ok or any(launches[k] == 0 for k in _build.FORWARD):
        raise AssertionError("TTA did not run 18 passes, gave probabilities outside [0, 1], or skipped a kernel")
    del pred, tta

    cfg32 = cut_depth(eval_preset(vitb384(compute_dtype="float32")))
    cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
    gpu = TTAPredictor(Predictor(copy.deepcopy(cpu_model), cfg32, names[:20]), min_sizes=(400,))
    cpu = TTAPredictor(Predictor(cpu_model, cfg32, names[:20], device="cpu"), min_sizes=(400,))
    d = (gpu.probs(image).cpu() - cpu.probs(image)).abs()
    log(f"    fp32, scale 400 x hflip, 20 classes: GPU vs the port on the CPU max|d prob| {d.max().item():.3e} "
        f"(bound {PROB_BOUND:.0e})")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 TTA on the card disagrees with the CPU port")


def train_cli_phase(smi, _build) -> None:
    """Phase 21: tools.train for 3 steps through the mapper, then tools.eval
    of its checkpoint."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.data import catalogs, loader, mapper
    from catseg_tpu_torch.tools import eval as eval_cli
    from catseg_tpu_torch.tools import train as train_cli
    from catseg_tpu_torch.train import loop

    root = str(FIXTURES / "dataset")
    cfg = vitb384()
    log("[21] tools.train: vitb384 (bf16, pooling 2x2), B=4, 3 steps on the fixture dataset through the mapper "
        "(ADE-150 names), then tools.eval of its model_final.pth")
    with tempfile.TemporaryDirectory() as tmp:
        pairs = loader.list_dataset(catalogs.get_dataset("ade150"), root=photo_dataset(tmp, 16))
        batches = mapper.train_batches(pairs, cfg.batch_size, np.random.default_rng(SEED), crop_size=cfg.crop_size,
                                       color_aug=cfg.color_aug, ignore=cfg.ignore_value)
        next(batches)
        secs = []
        for _ in range(10):
            t = time.perf_counter()
            next(batches)
            secs.append(time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as out:
        real_train = train_cli.train
        train_cli.train = functools.partial(loop.train, log_every=1)   # a metrics.json line every step
        try:
            state, launches = run_counted(lambda: train_cli.main(
                ["--config", "vitb384", "--dataset", "ade20k_150_test_sem_seg", "--data-root", root, "--output",
                 out, "--steps", "3"]), _build)
        finally:
            train_cli.train = real_train
        with open(Path(out) / "metrics.json") as f:
            losses = [json.loads(line)["loss_sem_seg"] for line in f if "loss_sem_seg" in line]
        final = Path(out) / "model_final.pth"
        log(f"    step {state.step}, losses {[round(x, 5) for x in losses]}, model_final.pth {final.exists()}; "
            f"host {statistics.median(secs) * 1e3:.1f} ms a batch of 4 (the mapper on 480x640 JPEGs, median of 10) "
            f"on {smi}; "
            f"launches {launches}")
        missing = [k for k in _build.FORWARD + _build.BACKWARD if launches[k] == 0]
        if state.step != 3 or len(losses) != 3 or not all(math.isfinite(x) for x in losses) or not final.exists() \
                or missing:
            raise AssertionError(f"tools.train: step {state.step}, losses {losses}, never launched {missing}")
        del state
        torch.cuda.empty_cache()
        m = eval_cli.main(["--config", "vitb384", "--checkpoint", str(final), "--benchmarks", "ade150",
                           "--data-root", root])["ade150"]
    log(f"    tools.eval --checkpoint model_final.pth: {m['num_images']} images, mIoU {m['mIoU']:.4f}")
    if m["num_images"] != 4 or not np.isfinite(m["mIoU"]):
        raise AssertionError("tools.eval of the trained checkpoint failed")
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        state, launches = run_counted(lambda: train_cli.main(
            ["--config", "fusion_ver31", "--dataset", "ade20k_150_test_sem_seg", "--data-root", root, "--output",
             out, "--steps", "2"]), _build)
        final = Path(out) / "model_final.pth"
        log(f"    tools.train --config fusion_ver31 --steps 2: step {state.step}, model_final.pth {final.exists()} "
            f"in {time.perf_counter() - t:.1f} s; launches {launches}")
        if state.step != 2 or not final.exists() or any(launches[k] == 0 for k in VER31_TRAIN):
            raise AssertionError("tools.train --config fusion_ver31 failed")
        del state
        torch.cuda.empty_cache()


TIER_PRESETS = ("vitl336", "vith336", "vitg336")


def memory_line() -> str:
    from catseg_tpu_torch.utils.profiling import device_memory_stats

    m = device_memory_stats()["cuda:0"]
    return (f"memory in use {m['bytes_in_use'] / 2**30:.2f} GiB, peak {m['peak_bytes_in_use'] / 2**30:.2f} GiB of "
            f"{m['bytes_limit'] / 2**30:.2f} GiB")


def tier_serving_phase(smi, _build, images, hws, canvas, names) -> None:
    """Phase 22: the larger encoder tiers at full width and depth, seeded
    random weights, eval_preset, bf16, T = 150; for vitl336 also the T = 459
    top-k batch and one whole-image predict_argmax."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    for preset in TIER_PRESETS:
        cfg = configs.eval_preset(getattr(configs, preset)())
        v = cfg.clip
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_catseg(cfg, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[22] {preset}: {v.name} ({v.layers} layers, width {v.width}, {v.heads} heads of "
            f"{v.width // v.heads}, MLP {v.mlp_width}, {v.act}; text width {v.text_width}), {n_params / 1e6:.1f} M "
            f"parameters, seeded init + copy to the card {init_s:.1f} s; {memory_line()}")
        pred = Predictor(model, cfg, names)
        pred.preds_sliding_batch(images, hws, canvas)                    # warm-up
        preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
        expect = [k for k in _build.FORWARD if k != "dense_attention" or v.width // v.heads == 64]
        log(f"    launches in one 2-image run (T=150): {launches}")
        if (any(launches[k] == 0 for k in expect) or any(launches[k] for k in _build.UNFUSED + _build.BACKWARD)
                or (launches["dense_attention"] > 0) != ("dense_attention" in expect)):
            raise AssertionError(f"{preset}: a kernel of {expect} never launched, or another one did")
        check_preds(preds, canvas, len(names))
        check_probs(pred.probs_sliding_batch(images), len(names))
        ips, med = images_per_s(pred, images, hws, canvas)
        log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; {memory_line()}")
        if preset == "vitl336":
            names459 = configs.class_names("pc459")
            pred = Predictor(model, cfg, names459)
            pred.preds_sliding_batch(images, hws, canvas)
            preds459, topk = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
            if topk["class_layer"] == 0 or topk["decoder"] == 0 or any(topk[k] for k in _build.UNFUSED):
                raise AssertionError("vitl336 T=459: the class-layer or decoder kernel never launched, or an "
                                     "unfused stage's did")
            check_preds(preds459, canvas, len(names459))
            ips459, med459 = images_per_s(pred, images, hws, canvas)
            log(f"    T=459 (PC-459, top-k to pad_len 256): {ips459:.3f} images/s ({med459 * 1e3:.1f} ms); launches "
                f"{topk}")
            whole = configs.vitl336()
            pred = Predictor(model, whole, names)
            pred.predict_argmax(images[0])
            t = time.perf_counter()
            labels, wl = run_counted(lambda: pred.predict_argmax(images[0]), _build)
            whole_ms = (time.perf_counter() - t) * 1e3
            if (labels.shape != images[0].shape[:2] or labels.min() < 0 or labels.max() >= len(names)
                    or any(wl[k] == 0 for k in _build.FORWARD)):
                raise AssertionError(f"vitl336 whole image: labels {labels.shape}, launches {wl}")
            log(f"    whole-image predict_argmax ({images[0].shape[0]}x{images[0].shape[1]} zero-padded to "
                f"768x768, resized to {whole.clip_resolution}^2, pooling 2x2): {whole_ms:.1f} ms with the launch "
                f"count; launches {wl}")
        del pred, model
        torch.cuda.empty_cache()
        log(f"    freed: {memory_line()}")


def tier_parity_phase(image, names) -> None:
    """Phase 23: fp32 vitl336, one whole-image forward on the card against
    the port on the CPU, 20 classes."""
    from catseg_tpu_torch.configs import vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[23] fp32 parity of vitl336: one whole-image forward, 20 classes, CLIP cut (cut_depth), GPU kernels vs the "
        "port on the CPU")
    cfg = cut_depth(vitl336(compute_dtype="float32"))
    cpu_model = init_catseg_(CATSeg(cfg), SEED).eval()
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    p_gpu = gpu.probs_whole(image).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg, names, device="cpu").probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    log(f"    probs {tuple(p_gpu.shape)}: max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean "
        f"{d.mean().item():.3e}; the CPU's forward {time.perf_counter() - t:.1f} s")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 vitl336 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def fused_qkv_checkpoint(sd: dict) -> dict:
    """A state dict with each CLIP attention's q / k / v weights fused into
    one ``in_proj_weight``, as the OpenAI and open_clip files hold them."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith("attn.q_proj_weight")]:
        stem = k[:-len("q_proj_weight")]
        out[stem + "in_proj_weight"] = torch.cat([out.pop(f"{stem}{n}_proj_weight") for n in "qkv"])
    return out


def converter_phase(smi, _build) -> None:
    """Phase 25: a synthetic fused-qkv vitl336 checkpoint through the
    converter and tools.parity_check --limit on the fixture set."""
    from catseg_tpu_torch.configs import vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.tools import parity_check
    from catseg_tpu_torch.weights import convert

    log("[25] a released-format vitl336 checkpoint (qkv fused, {'model': sd}) through tools.parity_check --limit 4 "
        "on the fixture set (ADE-150 layout)")
    sd = init_catseg_(CATSeg(vitl336()), SEED + 5).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model_large.pth")
        torch.save({"model": fused_qkv_checkpoint(sd)}, path)
        t = time.perf_counter()
        back = convert.convert_catseg_checkpoint(convert.load_torch_checkpoint(path), vitl336().num_layers)
        same = set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
        log(f"    {Path(path).stat().st_size / 2**30:.2f} GiB file; read and converted in "
            f"{time.perf_counter() - t:.1f} s; bit-equal to the model it came from {same}")
        del back
        rc, launches = run_counted(lambda: parity_check.main(
            ["--config", "vitl336", "--checkpoint", path, "--benchmarks", "ade150", "--data-root",
             str(FIXTURES / "dataset"), "--limit", "4"]), _build)
    log(f"    parity_check exit code {rc}; launches {launches}; on {smi}")
    if not same or rc != 0 or any(launches[k] == 0 for k in _build.FORWARD):
        raise AssertionError("the converted checkpoint differs from its source, parity_check failed, or it never "
                             "launched a kernel of the path")
    torch.cuda.empty_cache()


def build_timed(cfg):
    """(model on the card, seeded-init seconds, parameters) after resetting
    the allocator's peak."""
    from catseg_tpu_torch.core.catseg import build_catseg

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_catseg(cfg, seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, sum(p.numel() for p in model.parameters())


def check_launches(launches, expect, absent, what) -> None:
    if any(launches[k] == 0 for k in expect) or any(launches[k] for k in absent):
        raise AssertionError(f"{what}: a kernel of {list(expect)} never launched, or one of {list(absent)} did: "
                             f"{launches}")


def check_path_calls(calls, what: str, expect=()) -> None:
    """Every kernel call of a path against its plain version on the same
    inputs, at [3]'s bound for the call's dtype: ``calls`` recorded on the
    path (``selfcheck.recorded_calls``) and checked here, or the dict of
    ``selfcheck.checked_calls``, checked as they were made; fails if one
    disagrees or a kernel of ``expect`` was never called."""
    from catseg_tpu_torch.kernels import selfcheck

    if isinstance(calls, dict):
        summary = calls
    else:
        groups = {}
        for name, args in calls:
            groups.setdefault((name, args[0].dtype), []).append((name, args))
        summary = {(name, dt): (*selfcheck.check_calls(cs, dt)[name], tuple(cs[0][1][0].shape),
                                tuple(sorted({a[0].shape[-1] for _, a in cs})))
                   for (name, dt), cs in groups.items()}
    bad = [k for k in expect if not any(name == k for name, _ in summary)]
    for (name, dt), (n, err, rel, shape, widths) in sorted(summary.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        bound = selfcheck.bound(name, dt)
        log(f"    {name:16s} {str(dt)[6:]:8s} {n:4d} calls of this path, first input {shape}, "
            f"last-axis widths {list(widths)}: max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e})")
        if not rel <= bound:
            bad.append(f"{name} {dt}")
    if bad:
        raise AssertionError(f"{what}: on the path's own inputs these kernels disagree with their plain versions, "
                             f"or were never called: {bad}")


# kernels no fusion serving path launches (Ver14's head proposals aside):
# FusionUP and Ver31's embeds are plain compositions, nothing trains
FUSION_ABSENT = ("corr_embed", "decoder", "swin_block_bwd", "class_layer_bwd", "decoder_bwd", "window_attention",
                 "mlp", "linear_attention")


def ver31_serving_phase(smi, _build, images, hws, canvas, names):
    """Phase 26; returns the model for [28]."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    cfg = configs.eval_preset(configs.fusion_ver31())
    model, init_s, n_params = build_timed(cfg)
    log(f"[26] Ver31 fusion_ver31(): RemoteCLIP ViT-B/32 at {cfg.fusion.clip_resolution}^2 + DINO ViT-B/8 at "
        f"{cfg.fusion.encoder_resolution}^2, eval preset, bf16, T=150; {n_params / 1e6:.1f} M parameters, seeded init "
        f"+ copy to the card {init_s:.1f} s; {memory_line()}")
    pred = Predictor(model, cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run (10 tiles): {launches}; {memory_line()}")
    check_launches(launches, ("layer_norm", "dense_attention", "swin_block", "class_layer"), FUSION_ABSENT, "Ver31")
    preds = check_preds(preds, canvas, len(names))
    # each kernel on the very inputs this path hands it (#6 without guidance)
    with selfcheck.recorded_calls() as calls:
        probs = pred.probs_sliding_batch(images)
    check_probs(probs, len(names))
    del probs
    guided = sum(args[1] is not None or args[2] is not None for name, args in calls if name == "class_layer")
    log(f"    class layer calls with text guidance: {guided}")
    if guided:
        raise AssertionError("Ver31's class layer took text guidance")
    check_path_calls(calls, "Ver31 sliding", ("layer_norm", "dense_attention", "swin_block", "class_layer"))
    del calls
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; "
        f"{len(np.unique(preds.numpy()))} distinct labels")
    del pred
    torch.cuda.empty_cache()
    return model


def ver31_parity_phase(image, names) -> None:
    """Phase 27: fp32 Ver31, one whole-image forward, GPU against the CPU port."""
    from catseg_tpu_torch.configs import fusion_ver31
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[27] fp32 parity of fusion_ver31(): one whole-image forward, 20 classes, CLIP cut (cut_depth), GPU kernels "
        "vs the port on the CPU")
    cfg = cut_depth(fusion_ver31(compute_dtype="float32"))
    cpu_model = build_catseg(cfg, seed=SEED, device="cpu")
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    p_gpu = gpu.probs_whole(image).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg, names, device="cpu").probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    log(f"    probs {tuple(p_gpu.shape)} in [{p_gpu.min().item():.4f}, {p_gpu.max().item():.4f}]: max|d prob| "
        f"{d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}; the CPU's forward "
        f"{time.perf_counter() - t:.1f} s")
    if p_gpu.shape != (96, 96, len(names)) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 Ver31 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def ver31_topk_phase(smi, _build, model, images, hws, canvas) -> None:
    """Phase 28: Ver31 over ADE-847's names."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[28] Ver31 top-k path: 847 ADE-full names (each volume its own top-k, pad_len 256), bf16")
    names847 = configs.class_names("ade847")
    pred = Predictor(model, model.cfg, names847)
    pred.preds_sliding_batch(images, hws, canvas)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    check_launches(launches, ("layer_norm", "dense_attention", "swin_block", "class_layer"), FUSION_ABSENT,
                   "Ver31 T=847")
    check_preds(preds, canvas, len(names847))
    check_probs(pred.probs_sliding_batch(images), len(names847))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s at T=847 (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()


@torch.no_grad()
def livelier_sam_(model, seed: int):
    """The mask decoder's and prompt encoder's weights x5 and the SAM
    encoder's rel-pos tables drawn N(0, 0.02) from ``seed`` (the seeded
    init leaves them 0), so refined logits are O(1) and the rel-pos terms
    run."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith(("sam_decoder.", "sam_prompt_encoder.mask")) and p.ndim >= 2:
            p.mul_(5.0)
        elif name.startswith("sam_encoder.") and "rel_pos" in name:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def ver14_phase(smi, _build, images, hws, canvas, names) -> None:
    """Phase 29: Ver14 sliding (raw-corr proposals), the head proposals'
    whole-image path, and fp32 parity."""
    import dataclasses

    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    cfg = configs.eval_preset(configs.fusion_ver14())
    model, init_s, n_params = build_timed(cfg)
    log(f"[29] Ver14 fusion_ver14(): CLIP ViT-B/16 at {cfg.fusion.clip_resolution}^2 + SAM ViT-B at "
        f"{cfg.fusion.encoder_resolution}^2, refine_from={cfg.fusion.refine_from!r}, eval preset, bf16, T=150; "
        f"{n_params / 1e6:.1f} M parameters, seeded init + copy to the card {init_s:.1f} s; {memory_line()}")
    pred = Predictor(model, cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)
    torch.cuda.reset_peak_memory_stats()
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run (10 tiles): {launches}; {memory_line()}")
    check_launches(launches, ("layer_norm", "dense_attention"),
                   ("swin_block", "class_layer") + FUSION_ABSENT, "Ver14 raw_corr")
    # every call of that run again, each held against its plain version on
    # its own inputs (#1 at 768 in CLIP and SAM, 256 in the mask decoder)
    with selfcheck.recorded_calls() as calls:
        pred.preds_sliding_batch(images, hws, canvas)
    check_path_calls(calls, "Ver14 raw_corr sliding", ("layer_norm", "dense_attention"))
    del calls
    preds = check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; "
        f"{len(np.unique(preds.numpy()))} distinct labels")
    del pred, model
    torch.cuda.empty_cache()

    head = configs.fusion_ver14(fusion=dataclasses.replace(cfg.fusion, refine_from="head"))
    pred = Predictor(build_catseg(head, seed=SEED), head, names)
    pred.predict_argmax(images[0])
    t = time.perf_counter()
    labels, wl = run_counted(lambda: pred.predict_argmax(images[0]), _build)
    ms = (time.perf_counter() - t) * 1e3
    log(f"    refine_from='head', whole-image predict_argmax (pooling 2x2): {ms:.1f} ms with the launch count; "
        f"launches {wl}")
    check_launches(wl, _build.FORWARD, _build.BACKWARD + _build.UNFUSED, "Ver14 head")
    if labels.shape != images[0].shape[:2] or labels.min() < 0 or labels.max() >= len(names):
        raise AssertionError(f"Ver14 head labels {labels.shape} in [{labels.min()}, {labels.max()}]")
    with selfcheck.recorded_calls() as calls:
        pred.predict_argmax(images[0])
    check_path_calls(calls, "Ver14 head whole image", _build.FORWARD)
    del calls
    del pred
    torch.cuda.empty_cache()

    cfg32 = configs.fusion_ver14(compute_dtype="float32")
    cpu_model = livelier_sam_(build_catseg(cfg32, seed=SEED, device="cpu"), SEED + 7)
    gpu = Predictor(copy.deepcopy(cpu_model), cfg32, names[:8])
    with torch.inference_mode():
        logits = gpu.model(gpu._image(images[1])[None, :384, :384], gpu.text_feats, cfg32)
    p_gpu = gpu.probs_whole(images[1]).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg32, names[:8], device="cpu").probs_whole(images[1])
    d = (p_gpu - p_cpu).abs()
    log(f"    fp32 raw-corr whole image, T=8: refined logits of a tile in [{logits.min().item():.2f}, "
        f"{logits.max().item():.2f}]; probs {tuple(p_gpu.shape)}: max|d prob| {d.max().item():.3e} (bound "
        f"{PROB_BOUND:.0e})  mean {d.mean().item():.3e}; the CPU's forward {time.perf_counter() - t:.1f} s")
    if p_gpu.shape != (256, 256, 8) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 Ver14 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def fusion_converter_phase(smi) -> None:
    """Phase 30: seeded Ver31 / Ver14 checkpoints through the converter, then
    tools.eval --config fusion_ver31 in its own process."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import init_catseg_, model_class
    from catseg_tpu_torch.weights import convert

    log("[30] fusion checkpoints ({'model': sd}, the fork's key names) through the converter; tools.eval "
        "--config fusion_ver31 --limit 2 on the fixture set")
    with tempfile.TemporaryDirectory() as tmp:
        for preset in ("fusion_ver31", "fusion_ver14"):
            cfg = getattr(configs, preset)()
            sd = init_catseg_(model_class(cfg)(cfg), SEED + 5).state_dict()
            path = str(Path(tmp) / f"{preset}.pth")
            torch.save({"model": sd}, path)
            t = time.perf_counter()
            back = convert.convert_catseg_checkpoint(convert.load_torch_checkpoint(path), cfg.num_layers)
            same = set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
            log(f"    {preset}: {len(sd)} tensors, {Path(path).stat().st_size / 2**30:.2f} GiB file; read and "
                f"converted in {time.perf_counter() - t:.1f} s; bit-equal to the model it came from {same}")
            if not same:
                raise AssertionError(f"the converted {preset} checkpoint differs from its source")
            del sd, back
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "catseg_tpu_torch.tools.eval", "--config", "fusion_ver31",
                          "--benchmarks", "ade150", "--data-root", str(FIXTURES / "dataset"), "--limit", "2"],
                         capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("copypaste")]
    log(f"    tools.eval exit code {res.returncode} in {time.perf_counter() - t:.1f} s: {line} on {smi}")
    if res.returncode != 0 or not line:
        raise AssertionError(f"tools.eval --config fusion_ver31 failed: {res.stderr[-2000:]}")


# the Ver31 train step's kernels: the CLIP's, the aggregator's forward and
# backward (FusionUP and the embeds are plain compositions under autograd)
VER31_TRAIN = ("layer_norm", "dense_attention", "swin_block", "class_layer", "swin_block_bwd", "class_layer_bwd")


def ver31_train_phase(dev, smi, _build) -> dict:
    """Phase 31: the Ver31 train step; every kernel call of one step against
    its plain version on the step's own inputs."""
    from catseg_tpu_torch.configs import fusion_ver31

    log("[31] train step, fusion_ver31() at full width and depth (bf16, pooling 2x2, DINO frozen), B=4, T=171, "
        "384^2 crops")

    def check(calls):
        classes = [a for name, a in calls if name in ("class_layer", "class_layer_bwd")]
        guided = sum(a[1] is not None or a[2] is not None for a in classes)
        log(f"    {len(classes)} class layer forward and backward calls, {guided} with text guidance")
        if guided or not classes:
            raise AssertionError("Ver31's class layers took text guidance in the train step, or none ran")
        check_path_calls(calls, "Ver31 train step", VER31_TRAIN)

    return train_step_phase(dev, smi, _build, fusion_ver31(), VER31_TRAIN,
                            ("corr_embed", "decoder", "decoder_bwd") + _build.UNFUSED, steps=10, check_calls=check)


# frozen in Ver14 besides CLIP outside q / v (implicit_fusion_Ver14.py:32-43)
VER14_FROZEN = ("sam_encoder.", "sam_decoder.iou_prediction_head.", "sam_prompt_encoder.point_embeddings.",
                "sam_prompt_encoder.not_a_point_embed.", "sam_prompt_encoder.no_mask_embed.",
                "sam_prompt_encoder.pe_layer.")


def ver14_train_phase(dev, smi, _build) -> dict:
    """Phase 32: the Ver14 train step (raw-corr proposals), each refinement
    step recomputed in the backward."""
    from catseg_tpu_torch.configs import fusion_ver14

    cfg = fusion_ver14()
    log(f"[32] train step, fusion_ver14() (refine_from={cfg.fusion.refine_from!r}, bf16, SAM frozen), B=4, T=171, "
        f"384^2 crops: 684 mask-decoder instances in steps of {cfg.fusion.refine_chunk}, each recomputed in the "
        "backward; loss = BCE(coarse) + BCE(refined)")
    return train_step_phase(dev, smi, _build, cfg, ("layer_norm", "dense_attention"),
                            ("corr_embed", "swin_block", "class_layer", "decoder") + _build.BACKWARD + _build.UNFUSED,
                            steps=5, must_move=lambda n: n.startswith(("sam_prompt_encoder.mask_downscaling.",
                                                                       "sam_decoder.transformer.")),
                            must_freeze=lambda n: n.startswith(VER14_FROZEN))


def fusion_train_parity_phase(dev) -> None:
    """Phase 33: [9] for both fusion families."""
    import dataclasses

    from catseg_tpu_torch import configs

    log("[33] fp32 train-step parity of fusion_ver31() (CLIP cut, cut_depth) and fusion_ver14() (refine_chunk 8, "
        "mask decoder x5): 1 crop, 8 classes, GPU vs CPU")
    log("    Ver31:")
    train_parity_phase(dev, cut_depth(configs.fusion_ver31(compute_dtype="float32")))
    cfg = configs.fusion_ver14(compute_dtype="float32")
    log("    Ver14:")
    train_parity_phase(dev, cfg.replace(fusion=dataclasses.replace(cfg.fusion, refine_chunk=8)),
                       prepare=lambda m: livelier_sam_(m, SEED + 7))


def sam_tools_phase(smi, _build) -> None:
    """Phase 34: SamPredictor and AutomaticMaskGenerator at SAM ViT-B, fp32."""
    from catseg_tpu_torch.core.sam import SAM_VITB, SAMEncoder, init_sam_
    from catseg_tpu_torch.core.sam_decoder import MaskDecoder, PromptEncoder, init_prompt_decoder_
    from catseg_tpu_torch.data.image_io import decode_rgb
    from catseg_tpu_torch.infer.amg import AutomaticMaskGenerator
    from catseg_tpu_torch.infer.sam_predictor import SamPredictor

    image = decode_rgb(str(FIXTURES / "images" / "photo_420.jpg"))
    log(f"[34] SAM tools at SAM ViT-B (1024^2, fp32, seeded; mask decoder x5): SamPredictor on photo_420.jpg "
        f"({image.shape[0]}x{image.shape[1]}), AutomaticMaskGenerator(points_per_side=32)")
    gen = torch.Generator().manual_seed(SEED + 11)
    sam = torch.nn.Module()
    sam.sam_encoder, sam.sam_prompt_encoder, sam.sam_decoder = init_sam_(SAMEncoder(SAM_VITB), gen), \
        PromptEncoder(SAM_VITB.out_chans), MaskDecoder(SAM_VITB.out_chans)
    init_prompt_decoder_(sam.sam_prompt_encoder, sam.sam_decoder, gen)
    livelier_sam_(sam, SEED + 12)
    pred = SamPredictor(copy.deepcopy(sam))
    _, launches = run_counted(lambda: pred.set_image(image), _build)
    log(f"    set_image launches {launches}")
    check_launches(launches, ("layer_norm",), ("corr_embed", "swin_block", "class_layer", "decoder")
                   + _build.BACKWARD + _build.UNFUSED, "SamPredictor.set_image")

    def host_ms(fn, reps):
        fn()
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t) * 1e3)
        return statistics.median(secs)

    point = dict(point_coords=np.array([[300.0, 200.0]], np.float32), point_labels=np.array([1]))
    box = dict(box=np.array([120.0, 80.0, 500.0, 400.0], np.float32))
    masks, iou, low = pred.predict(**point)
    prompts = {"point": point, "box": box, "mask": dict(mask_input=low[int(np.argmax(iou))])}
    times = {k: host_ms(lambda kw=kw: pred.predict(**kw), 10) for k, kw in prompts.items()}
    set_ms = host_ms(lambda: pred.set_image(image), 5)
    log(f"    set_image {set_ms:.1f} ms (median of 5); predict " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
        + f" (median of 10, multimask, masks at {masks.shape[1]}x{masks.shape[2]}) on {smi}")
    cpu = SamPredictor(sam, device="cpu")
    t = time.perf_counter()
    cpu.set_image(image)
    want = cpu.predict(**point, multimask_output=False)[2]
    got = pred.predict(**point, multimask_output=False)[2]
    d = np.abs(got - want).max()
    log(f"    fp32 point prompt, low-res logits {got.shape} in [{want.min():.2f}, {want.max():.2f}]: GPU vs the port "
        f"on the CPU max|d| {d:.3e} (bound 5e-4); the CPU's set_image and predict {time.perf_counter() - t:.1f} s")
    if not d < 5e-4 or not np.isfinite(got).all():
        raise AssertionError("the SAM predictor on the card disagrees with the CPU port")

    amg = AutomaticMaskGenerator((pred.encoder, pred.pe, pred.dec), points_per_side=32,
                                 pred_iou_thresh=-1e9, stability_score_thresh=0.5, box_nms_thresh=0.7)
    canvas = pred.preprocess(image)[0].numpy()
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        records = amg.generate(canvas)
        secs.append(time.perf_counter() - t)
    log(f"    AutomaticMaskGenerator.generate (1024 points, 3072 masks, stability > 0.5, NMS 0.7): "
        f"{statistics.median(secs):.3f} s (median of 3) on {smi}; {len(records)} records")
    if not records or not all(r["segmentation"]["size"] == [256, 256] for r in records):
        raise AssertionError("AutomaticMaskGenerator gave no records, or records of another size")
    del pred, cpu, amg, sam
    torch.cuda.empty_cache()


def visuals_phase(smi, _build) -> None:
    """Phase 35: evaluate_benchmark(dump_visuals=4, dump_predictions=...) on the
    fixture set, then tools.viz_results on its JSON."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.data import catalogs, loader
    from catseg_tpu_torch.evaluation import harness
    from catseg_tpu_torch.tools import viz_results

    root = str(FIXTURES / "dataset")
    cfg = eval_preset(vitb384())
    spec = catalogs.get_dataset("ade150")
    gts = {Path(i).stem: loader.load_gt(g).shape for i, g in loader.list_dataset(spec, root=root)}
    log(f"[35] visuals: evaluate_benchmark(dump_visuals=4, dump_predictions) at eval_preset(vitb384()), bf16, "
        f"T=150, on the {len(gts)}-image fixture set, then tools.viz_results")
    model = build_catseg(cfg, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        vis, dump, viz = Path(tmp, "vis"), str(Path(tmp, "preds.json")), Path(tmp, "viz")
        harness.evaluate_benchmark(model, cfg, "ade150", root=root, verbose=False)   # warm-up
        t = time.perf_counter()
        m, launches = run_counted(lambda: harness.evaluate_benchmark(
            model, cfg, "ade150", root=root, dump_visuals=4, visuals_dir=str(vis), dump_predictions=dump,
            verbose=False), _build)
        secs = time.perf_counter() - t
        missing = [k for k in _build.FORWARD if launches[k] == 0]
        if missing or m["num_images"] != len(gts):
            raise AssertionError(f"the visuals run never launched {missing}, or counted {m['num_images']} images")
        names = sorted(f.name for f in vis.iterdir())
        shapes = [loader.load_image(str(vis / f)).shape for f in names]
        want = [(h, 3 * w, 3) for h, w in gts.values()]
        if names != [f"{spec.name}_{n:04d}.jpg" for n in range(4)] or shapes != want:
            raise AssertionError(f"visuals {names} of shapes {shapes}, want {want}")
        t = time.perf_counter()
        n = viz_results.main(["--input", dump, "--output", str(viz), "--benchmark", "ade150", "--data-root", root])
        viz_s = time.perf_counter() - t
        viz_shapes = {f.stem: loader.load_image(str(f)).shape for f in viz.iterdir()}
        if n != len(gts) or viz_shapes != {k: (h, 3 * w, 3) for k, (h, w) in gts.items()}:
            raise AssertionError(f"tools.viz_results wrote {n} panels of shapes {viz_shapes}")
    log(f"    launches {launches}; 4 strips {shapes}; {len(gts)} images in {secs:.3f} s with the strips "
        f"({m['images_per_sec']:.3f} images/s, the per-image loop); viz_results {n} panels in {viz_s:.3f} s; "
        f"on {smi}")
    del model
    torch.cuda.empty_cache()


def demo_phase(smi, _build) -> None:
    """Phase 36: tools.demo on two fixture JPEGs, --classes and --class-json,
    sequential and --parallel."""
    from catseg_tpu_torch.data import loader
    from catseg_tpu_torch.tools import demo

    inputs = [str(FIXTURES / "images/photo_420.jpg"), str(FIXTURES / "images/photo_444.jpg")]
    log("[36] tools.demo at vitb384 (sliding, bf16) on two fixture JPEGs: --classes (5), --class-json ade150.json "
        "sequential and --parallel")
    with tempfile.TemporaryDirectory() as tmp:
        def run(extra, inp, out):
            res, launches = run_counted(lambda: demo.main(["--input", *inp, "--output", str(Path(tmp, out)),
                                                           *extra]), _build)
            return res["preds"], launches, res["ms_per_image"]

        few, few_l, few_ms = run(["--classes", "sky,tree,building,road,person"], inputs, "a")
        seq, seq_l, seq_ms = run(["--class-json", "ade150.json"], inputs * 2, "b")
        par, par_l, par_ms = run(["--class-json", "ade150.json", "--parallel"], inputs * 2, "c")
        bad = [k for k in _build.FORWARD for launches in (few_l, seq_l, par_l) if launches[k] == 0]
        shapes = [loader.load_image(str(Path(tmp, d, Path(p).name))).shape for d in "abc" for p in inputs]
        want = [loader.load_image(p).shape for p in inputs] * 3
        same = all(np.array_equal(par[p], seq[p]) for p in inputs)
        if bad or shapes != want or not same or any(few[p].max() >= 5 for p in inputs):
            raise AssertionError(f"tools.demo: never launched {bad}, overlays {shapes} (want {want}), --parallel "
                                 f"== sequential {same}")
    log(f"    launches (--class-json, sequential, 4 inputs) {seq_l}; --parallel argmax == sequential {same}; "
        f"ms an image (first load to last overlay, model build excluded): --classes {few_ms:.1f} (2 inputs), "
        f"--class-json {seq_ms:.1f}, --parallel {par_ms:.1f} (4 inputs); on {smi}")


def viz_attn_phase(smi, _build) -> None:
    """Phase 37: tools.viz_attn at vitb384, layers 3, 7, 11; fp32 maps
    against the port on the CPU."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.data import loader
    from catseg_tpu_torch.tools import viz_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image_path = str(FIXTURES / "images/photo_420.jpg")
    layers = (3, 7, 11)
    log("[37] tools.viz_attn at vitb384 (CLIP ViT-B/16 at 384^2, fp32 maps), layers 3, 7, 11")
    with tempfile.TemporaryDirectory() as tmp:
        written, launches = run_counted(lambda: viz_attn.main(["--input", image_path, "--layers", "3,7,11",
                                                               "--output", tmp]), _build)
        shapes = [loader.load_gt(p).shape for p in written]
    cfg = vitb384()
    model = build_catseg(cfg, seed=SEED)
    image = loader.load_image(image_path)
    gpu = [m.cpu() for m in viz_attn.attention_maps(model, cfg, image, layers)]
    t = time_ms(lambda: viz_attn.attention_maps(model, cfg, image, layers), reps=5)
    cpu = viz_attn.attention_maps(model.cpu(), cfg, image, layers)
    err = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    rows = max((g.sum(-1) - 1).abs().max().item() for g in gpu)
    log(f"    launches {launches}; {len(written)} PNGs {shapes}; fp32 maps vs the CPU port max {err:.3e} "
        f"(bound 1e-5), rows sum to 1 within {rows:.3e}; maps of 3 layers {t:.2f} ms on {smi}")
    if launches["layer_norm"] == 0 or len(written) != 3 or not err <= 1e-5 or not rows <= 1e-5 or \
            shapes != [(24 * 8, 12 * 24 * 8)] * 3:
        raise AssertionError("tools.viz_attn: #1 not launched, maps off the CPU port's, or PNGs missing")
    del model


def export_phase(smi, _build) -> None:
    """Phase 38: tools.export at vitb384 (bf16, T = 150) with --check, the
    artifact against the live serve module and the Predictor; an fp32
    export at T = 20 against the CPU port."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, compute_dtype, init_catseg_
    from catseg_tpu_torch.infer import export as texport
    from catseg_tpu_torch.infer.pipeline import Predictor, canvas_to_sliding_inputs
    from catseg_tpu_torch.text.embed import forward_text_embeds
    from catseg_tpu_torch.tools import export as export_cli

    log("[38] tools.export at eval_preset(vitb384()), bf16, T=150, --canvas 1024x1024 --out-canvas 768x768 --check")
    rng = np.random.RandomState(SEED)
    image, exact = (rng.randint(0, 256, s, dtype=np.uint8) for s in ((512, 683, 3), (480, 960, 3)))

    def on_canvas(img):
        canvas = np.zeros((1024, 1024, 3), np.uint8)
        canvas[:img.shape[0], :img.shape[1]] = img
        return canvas, np.array(img.shape[:2], np.int32)

    canvas, hw = on_canvas(image)
    # 480x960: both resizes (to 640 and 384) take dyadic weights, exact in
    # fp32 whatever the order of the sums, so the Predictor's F.interpolate
    # and the artifact's in-graph weights give bit-equal CLIP inputs
    canvas_x, hw_x = on_canvas(exact)
    out_x = np.array([384, 768], np.int32)
    names = class_names("ade150")
    dev = torch.device("cuda")

    def input_diff(pred, img):
        c, h = on_canvas(img)
        with torch.inference_mode():
            a = canvas_to_sliding_inputs(torch.as_tensor(c, device=dev), torch.as_tensor(h, device=dev), pred.cfg)
            b = pred._inputs([img])
        return max((x - y[0]).abs().max().item() for x, y in zip(a, b))

    def text(model, cfg, n):
        with torch.inference_mode():
            tf = forward_text_embeds(model.clip, n, cfg.prompt_ensemble_type, compute_dtype=compute_dtype(cfg))
        return tf.clone()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.pt2")
        out = export_cli.main(["--config", "vitb384", "--class-json", "ade150.json", "--canvas", "1024x1024",
                               "--out-canvas", "768x768", "--output", path, "--check"])
        artifact = texport.load_exported(path)
        cfg = eval_preset(vitb384())
        model = build_catseg(cfg, seed=SEED)
        spec = texport.ExportSpec((1024, 1024), (768, 768), len(names))
        serve = texport.make_serve_fn(model, cfg, text(model, cfg, names), spec)
        artifact(canvas, hw, hw)   # warm-up
        got, launches = run_counted(lambda: artifact(canvas, hw, hw).cpu().numpy(), _build)
        with torch.inference_mode():
            live = serve(*(torch.as_tensor(a, device=dev) for a in (canvas, hw, hw))).cpu().numpy()
        pred = Predictor(model, cfg, names)
        agree = float((got[:512, :683] == pred.predict_argmax(image, (512, 683))).mean())
        got_x = artifact(canvas_x, hw_x, out_x).cpu().numpy()
        same_x = got_x[:384, :768] == pred.predict_argmax(exact, tuple(out_x))
        # pixels the Predictor's own fp32 resize of its bf16 probabilities
        # decides: a top-2 gap above fp32 rounding (an exact tie may go to
        # either class, and the two resizes round apart)
        top2 = torch.from_numpy(pred.predict(exact, tuple(out_x))["sem_seg"]).topk(2, dim=0).values
        decided = (top2[0] - top2[1] > DECIDED_TIE).numpy()
        agree_x, agree_x_all, decided_x = float(same_x[decided].mean()), float(same_x.mean()), float(decided.mean())
        diffs = input_diff(pred, image), input_diff(pred, exact)
        art_ms = time_ms(lambda: artifact(canvas, hw, hw), reps=10)
        pred_ms = time_ms(lambda: pred.predict_argmax(image, (512, 683)), reps=10)
        del artifact, serve, pred, model
        os.remove(path)
        torch.cuda.empty_cache()
        missing = [k for k in _build.FORWARD if launches[k] == 0]
        log(f"    export {out['export_s']:.1f} s, artifact {out['mb']:.1f} MB, load {out['load_s']:.1f} s, --check "
            f"{out['check']}; launches in the artifact's run {launches}; artifact == live serve module "
            f"{np.array_equal(got, live)}; artifact {art_ms:.2f} ms, predict_argmax {pred_ms:.2f} ms (medians of "
            f"10) on {smi}")
        log(f"    argmax agreement with Predictor.predict_argmax: 480x960 (CLIP inputs of the two paths max |d| "
            f"{diffs[1]:.3e}) {agree_x:.5f} of the {decided_x:.4f} of pixels whose top-2 gap exceeds {DECIDED_TIE:.0e} "
            f"(bound 0.99), {agree_x_all:.5f} of all (the rest are exact ties of bf16 probabilities); 512x683 (inputs "
            f"max |d| {diffs[0]:.3e}: the Predictor's F.interpolate and the artifact's weight products round apart, "
            f"and the random bf16 model's argmax follows any rounding) {agree:.5f}, read only")
        if missing or not np.array_equal(got, live) or not agree_x >= 0.99 or decided_x < 0.1 or diffs[1] != 0 \
                or got[512:].any() or got[:, 683:].any():
            raise AssertionError(f"the artifact never launched {missing}, differs from the live serve module, or "
                                 "disagrees with the Predictor on bit-equal inputs")

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = cut_depth(eval_preset(vitb384(compute_dtype="float32")))
        cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        spec32 = texport.ExportSpec((1024, 1024), (768, 768), 20)
        path32 = os.path.join(tmp, "serve32.pt2")
        t = time.perf_counter()
        texport.export_serving(gpu_model, cfg32, text(gpu_model, cfg32, names[:20]), spec32, path32)
        exp32_s = time.perf_counter() - t
        got32, launches32 = run_counted(lambda: texport.load_exported(path32)(canvas, hw, hw).cpu().numpy(), _build)
        os.remove(path32)
        with torch.inference_mode():
            cpu32 = texport.make_serve_fn(cpu_model, cfg32, text(cpu_model, cfg32, names[:20]), spec32)(
                torch.from_numpy(canvas), torch.from_numpy(hw), torch.from_numpy(hw)).numpy()
        agree32 = float((got32 == cpu32)[:512, :683].mean())
        pred32 = Predictor(gpu_model, cfg32, names[:20])
        agree32_pred = float((got32[:512, :683] == pred32.predict_argmax(image, (512, 683))).mean())
        log(f"    fp32 export at T=20 in {exp32_s:.1f} s; launches {launches32}; argmax agreement with the CPU port's "
            f"serve module {agree32:.5f} (bound 0.999), with the card's fp32 Predictor.predict_argmax "
            f"{agree32_pred:.5f} (bound 0.999)")
        if not agree32 >= 0.999 or not agree32_pred >= 0.999 or any(launches32[k] == 0 for k in _build.FORWARD):
            raise AssertionError("the fp32 artifact disagrees with the CPU port or the Predictor, or skipped a kernel")
        del pred32
        del gpu_model, cpu_model
        torch.cuda.empty_cache()


def fixture_eval_items(cfg):
    """The committed 4-image ADE-150 fixture set loaded as the harness loads
    it, its out canvas, and the ADE-150 names."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.data import catalogs, loader
    from catseg_tpu_torch.evaluation import harness

    pairs = loader.list_dataset(catalogs.get_dataset("ade150"), root=str(FIXTURES / "dataset"))
    items = [(loader.resize_shortest_edge(loader.load_image(i), cfg.min_size_test, cfg.max_size_test),
              loader.load_gt(g)) for i, g in pairs]
    return items, harness._canvas([g.shape for _, g in items]), class_names("ade150")


def sharded_eval(model, cfg):
    """evaluate_sharded over the fixture set in the current group (per-device
    batch 2, T = 150): (matrix, the launches of that run)."""
    from catseg_tpu_torch.core.catseg import compute_dtype
    from catseg_tpu_torch.evaluation.distributed import evaluate_sharded
    from catseg_tpu_torch.kernels import _build
    from catseg_tpu_torch.parallel.mesh import make_mesh
    from catseg_tpu_torch.text.embed import forward_text_embeds

    items, canvas, names = fixture_eval_items(cfg)
    with torch.inference_mode():
        text = forward_text_embeds(model.clip, names, cfg.prompt_ensemble_type, compute_dtype=compute_dtype(cfg))

    return run_counted(lambda: evaluate_sharded(model, cfg, make_mesh(), items, text, out_canvas=canvas,
                                                num_classes=len(names), ignore=255, per_device_batch=2), _build)


def nccl_world1_phase(smi, _build) -> tuple[dict, dict, np.ndarray, np.ndarray]:
    """Phase 39: a process group of one rank over NCCL: the data-parallel
    train step and evaluate_sharded, every collective on the card.  Returns
    the launches of the counted step and of evaluate_sharded, its matrix and
    the one-process harness's."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.evaluation import harness
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    log("[39] world size 1 over NCCL: the data-parallel train step at vitb384() (bf16), B=4, T=171, 3 steps; "
        "evaluate_sharded on the 4-image fixture set at eval_preset(vitb384()), bf16, T=150")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_process_group("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            cfg = vitb384()
            state = init_train_state(cfg, seed=SEED)
            step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")), mesh=mesh.make_mesh())
            images, targets = (t.to(dev) for t in synthetic_batch(4, 171, SEED))
            loss, train_launches = run_counted(lambda: step(state.model, images, targets), _build)
            losses, times = [loss.item()], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(state.model, images, targets).item())
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            missing = [k for k in _build.FORWARD + _build.BACKWARD if train_launches[k] == 0]
            log(f"    losses {[round(x, 6) for x in losses]}; launches of the counted step {train_launches}")
            log(f"    {ms:.1f} ms/step median of 3 (min {min(times):.1f}, max {max(times):.1f}), {4e3 / ms:.3f} "
                f"images/s; [8]'s one process without a group {STEP_MS[vitb384()]:.1f} ms/step; on {smi}")
            if missing or not all(np.isfinite(losses)):
                raise AssertionError(f"NCCL train step: losses {losses}, never launched {missing}")
            del state, step
            torch.cuda.empty_cache()

            cfg = eval_preset(vitb384())
            model = build_catseg(cfg, seed=SEED)
            want = harness.evaluate_benchmark(model, cfg, "ade150", root=str(FIXTURES / "dataset"),
                                              verbose=False)["_conf"]
            cm, eval_launches = sharded_eval(model, cfg)
            same = cm.dtype == np.int64 and np.array_equal(cm, want)
            log(f"    evaluate_sharded: {int(cm.sum())} pixels, int64 matrix equal to the one-process harness's "
                f"{same}; launches {eval_launches}")
            if not same or any(eval_launches[k] == 0 for k in _build.FORWARD):
                raise AssertionError("NCCL evaluate_sharded: matrix differs from the harness's, or a forward "
                                     "kernel never launched")
            del model
            torch.cuda.empty_cache()
        finally:
            mesh.destroy_process_group()
    return train_launches, eval_launches, cm, want


SHARED_CLASSES = 8   # [40]'s fp32 step: the first COCO names, pad terms live


def shared_card_rank(images, targets, params_path: str) -> dict:
    """Phase 40, one rank of two sharing cuda:0 over gloo (started by
    parallel.mesh.spawn): the fp32 data-parallel step on this rank's crop,
    3 more steps timed, then evaluate_sharded over the fixture set in bf16.
    Rank 0 saves its parameters after the first step to ``params_path``."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.kernels import _build
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut_depth(vitb384(compute_dtype="float32", batch_size=2))
    state = init_train_state(cfg, seed=SEED)
    step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")[:SHARED_CLASSES]),
                           mesh=mesh.make_mesh())
    img, tgt = (t.cuda() for t in mesh.shard_batch((images, targets)))
    loss, train_launches = run_counted(lambda: step(state.model, img, tgt).item(), _build)
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    if mesh.rank() == 0:
        torch.save(params, params_path)
    checksum = [float(p.double().abs().sum()) for p in params.values()]
    del params
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state.model, img, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del state, step
    torch.cuda.empty_cache()
    cfg = eval_preset(vitb384())
    cm, eval_launches = sharded_eval(build_catseg(cfg, seed=SEED), cfg)
    return {"rank": mesh.rank(), "loss": loss, "checksum": checksum, "ms": statistics.median(times),
            "train_launches": train_launches, "eval_launches": eval_launches, "cm": cm}


def shared_card_phase(smi, _build, want_cm, harness_cm) -> list:
    """Phase 40: two ranks sharing cuda:0 over gloo: the fp32 step against one
    process stepping the same global batch, evaluate_sharded against one
    process running the same per-rank batches in turn ([39]'s matrix)."""
    from catseg_tpu_torch.configs import class_names, vitb384
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    log("[40] two ranks sharing cuda:0 over gloo (a check of the multi-rank code on the card; it says nothing of "
        f"scaling): fp32 vitb384 step at global batch 2 (one crop a rank), {SHARED_CLASSES} classes; "
        "evaluate_sharded over the 4 fixtures in bf16 (per-device batch 2)")
    images, targets = synthetic_batch(2, SHARED_CLASSES, SEED)
    cfg = cut_depth(vitb384(compute_dtype="float32", batch_size=2))
    state = init_train_state(cfg, seed=SEED)
    step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")[:SHARED_CLASSES]))
    want_loss = step(state.model, images.cuda(), targets.cuda()).item()
    want = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params_rank0.pt")
        t0 = time.perf_counter()
        out = mesh.spawn(shared_card_rank, 2, images, targets, path, backend="gloo", devices=["cuda:0", "cuda:0"],
                         tmp_dir=tmp)
        wall = time.perf_counter() - t0
        got = torch.load(path, weights_only=True)
    scale = max(1.0, max(float(p.abs().max()) for p in want.values()))
    worst = max(float((got[n] - want[n]).abs().max()) for n in want)
    moved = sum(not torch.equal(got[n], p) for n, p in want.items())
    d_loss = abs(out[0]["loss"] - want_loss)
    same_ranks = out[0]["checksum"] == out[1]["checksum"] and out[0]["loss"] == out[1]["loss"]
    log(f"    loss {out[0]['loss']:.7f} vs one process {want_loss:.7f} (|d| {d_loss:.2e}, bound 1e-5); parameters "
        f"max |d| {worst:.2e} (bound 1e-4 x max(1, max |p|) = {1e-4 * scale:.2e}); ranks bit-equal {same_ranks}; "
        f"the two ranks' processes {wall:.1f} s from spawn to the last result")
    for r in out:
        log(f"    rank {r['rank']}: {r['ms']:.1f} ms/step median of 3 with both ranks on one card (fp32, one crop); "
            f"train launches {r['train_launches']}; eval launches {r['eval_launches']}; on {smi}")
    cm_same = all(r["cm"].dtype == np.int64 and np.array_equal(r["cm"], want_cm) for r in out)
    log(f"    evaluate_sharded over 2 ranks: int64 matrix equal to one process running the same per-rank batches in "
        f"turn {cm_same}; cells differing from the plain harness's matrix {int((out[0]['cm'] != harness_cm).sum())}")
    bad = [(r["rank"], k) for r in out for k in _build.FORWARD + _build.BACKWARD if r["train_launches"][k] == 0]
    bad += [(r["rank"], k) for r in out for k in _build.FORWARD if r["eval_launches"][k] == 0]
    if not d_loss < 1e-5 or not worst <= 1e-4 * scale or not same_ranks or not cm_same or bad or moved == 0:
        raise AssertionError(f"two ranks on one card: loss {d_loss}, parameters {worst}, ranks equal {same_ranks}, "
                             f"matrix equal {cm_same}, kernels never launched {bad}")
    return out


def tile_shard_phase(smi, _build, image) -> dict:
    """Phase 41: Predictor(mesh=) with two replicas on cuda:0 against the
    unsharded Predictor, fp32; then tools.demo --shard-tiles on one GPU."""
    import contextlib
    import io

    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.parallel.mesh import make_mesh
    from catseg_tpu_torch.tools import demo

    log("[41] tile-sharded latency: Predictor(mesh=make_mesh(devices=[cuda:0, cuda:0])), two replicas on the one "
        "card, eval_preset(vitb384(compute_dtype='float32')), T=150, one 480x640 image; then tools.demo "
        "--shard-tiles")
    cfg = eval_preset(vitb384(compute_dtype="float32"))
    names = class_names("ade150")
    model = build_catseg(cfg, seed=SEED)
    base = Predictor(model, cfg, names)
    sharded = Predictor(model, cfg, names, mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    want = base.probs_sliding(image)
    sharded.probs_sliding(image)          # the first call copies the second replica
    got, launches = run_counted(lambda: sharded.probs_sliding(image), _build)
    err = (got - want).abs()
    ok = torch.allclose(got, want, atol=2e-5, rtol=1e-4)

    def ms(pred):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.probs_sliding(image)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    t_sharded, t_base = ms(sharded), ms(base)
    log(f"    max |d prob| {err.max().item():.2e} (atol 2e-5, rtol 1e-4: {ok}); launches of one sharded image "
        f"{launches}; {t_sharded:.1f} ms an image sharded over 2 replicas on one card, {t_base:.1f} ms unsharded "
        f"(median of 5, host clock to a synchronize; one card, so no scaling is read); on {smi}")
    missing = [k for k in _build.FORWARD if launches[k] == 0]
    if not ok or missing or sharded._tile_sharded is None:
        raise AssertionError(f"tile-sharded probs disagree with the unsharded Predictor, or never launched {missing}")
    del base, sharded, model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = demo.main(["--input", str(FIXTURES / "images/photo_420.jpg"), "--output", tmp,
                             "--classes", "sky,tree,building,road,person", "--shard-tiles"])
    note = "only one device visible, running unsharded" in printed.getvalue()
    log(f"    tools.demo --shard-tiles on {torch.cuda.device_count()} GPU: note printed {note}, "
        f"{len(res['preds'])} overlay")
    if not note or len(res["preds"]) != 1:
        raise AssertionError("tools.demo --shard-tiles on one GPU did not run unsharded with its note")
    return {"ms_sharded": t_sharded, "ms": t_base, "launches": launches}


def mamba_phase(smi, _build) -> None:
    """Phase 42: the VSSBlock on the card against the port on the CPU, fp32."""
    from catseg_tpu_torch.core.mamba import SS2DConfig, VSSBlock, init_vss_block_

    cfg = SS2DConfig(d_model=96, d_state=16)
    log(f"[42] MambaIR VSSBlock (d_model {cfg.d_model}, d_state {cfg.d_state}, inner {cfg.d_inner}), fp32, "
        "2 x 32 x 32 x 96, sequential selective scan over L = 1024: the card against the port on the CPU")
    block = init_vss_block_(VSSBlock(cfg), SEED).eval()
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for p in block.parameters():   # livelier than the init's 0.02 weights
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        x = torch.randn((2, 32, 32, cfg.d_model), generator=gen)
        want = block(x)
        gpu, xc = copy.deepcopy(block).cuda(), x.cuda()
        got, launches = run_counted(lambda: gpu(xc).cpu(), _build)
        ms = time_ms(lambda: gpu(xc), reps=5, warmup=1)
    err = (got - want).abs().max().item()
    bound = 1e-5 * max(1.0, want.abs().max().item())
    log(f"    max |d| {err:.2e} (bound {bound:.2e}); launches {launches}; {ms:.2f} ms a block call on {smi}")
    if not err <= bound or launches["layer_norm"] == 0:
        raise AssertionError("the VSSBlock on the card disagrees with the CPU, or its LayerNorms never launched #1")


CLASS_FORWARD_T = (847, 150)   # [43]: top-k to 256 kept (128 a rank), and 150 (75 a rank)
CLASS_STEP_T = 171              # [44]: COCO-Stuff's train classes, 57 a rank over three
CLASS_LOGIT_BOUND = 2e-4        # [43] fp32 max |d logit| against one process (catseg_tpu's sharded-aggregator bound)


def class_forward_inputs(T: int, seed: int):
    """[43]'s aggregator inputs at vitb384's widths: 2 images of random CLIP
    features (24 x 24 x 512), T random text features, the three guidances."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(2, 24, 24, 512, generator=g)
    txt = torch.randn(2, T, 1, 512, generator=g)
    guid = tuple(torch.randn(2, s, s, c, generator=g) for s, c in ((24, 512), (48, 256), (96, 128)))
    return img, txt, guid


def on_card(inputs, dt):
    img, txt, guid = inputs
    return img.cuda().to(dt), txt.cuda().to(dt), tuple(g.cuda().to(dt) for g in guid)


def class_forward(agg, cfg, inputs, class_axis=None):
    """The aggregator on card ``inputs``: (logits, kept classes or None)."""
    from catseg_tpu_torch.core.aggregator import aggregator_forward

    with torch.no_grad():
        return aggregator_forward(agg, *inputs, cfg, return_classes=True, class_axis=class_axis)


def class_step_cfg(dt: str, batch: int):
    """[44]'s config: vitb384 at full width; the fp32 parity run at one crop
    and cut depth, as one process on the card runs it beside the ranks."""
    from catseg_tpu_torch.configs import vitb384

    cfg = vitb384(compute_dtype=dt, batch_size=batch)
    return cut_depth(cfg) if dt == "float32" else cfg


def class_step_rank(cfg, images, targets, n_class: int, params_path: str | None):
    """One train step of ``cfg`` over the mesh {1, n_class} on this rank:
    (loss, a checksum of every parameter after it); rank 0 saves the
    parameters to ``params_path`` where given."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    state = init_train_state(cfg, seed=SEED)
    axis = mesh.make_mesh(n_data=1, n_class=n_class)
    step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")), mesh=axis)
    loss = step(state.model, images.cuda(), targets.cuda()).item()
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    if params_path is not None and mesh.rank() == 0:
        torch.save(params, params_path)
    return loss, [float(p.double().abs().sum()) for p in params.values()]


FUSION_FORWARD = (("fusion_ver31", 847), ("fusion_ver31", 150), ("fusion_ver14", 150))   # [45] on {1, 2}
FUSION_FAMILIES = ("fusion_ver31", "fusion_ver14")
# [45]'s bounds on the fp32 step over {1, 3} against one process ([44]'s
# vitb384 step read a loss 6e-8 and parameters 1.1e-6 apart)
FUSION_LOSS_BOUND, FUSION_PARAM_BOUND = 1e-6, 1e-5
# kernels each family's serving forward and train step launch ([26], [29], [31], [32])
FUSION_LAUNCHES = {"fusion_ver31": ("layer_norm", "dense_attention", "swin_block", "class_layer"),
                   "fusion_ver14": ("layer_norm", "dense_attention")}
FUSION_STEP_LAUNCHES = {"fusion_ver31": VER31_TRAIN, "fusion_ver14": FUSION_LAUNCHES["fusion_ver14"]}


def fusion_cfg(family: str, dt: str, batch: int | None = None):
    """[45]'s config of ``family``: the serving preset (``batch`` None) or
    the train config at ``batch`` crops, at full width; the fp32 runs at cut
    depth."""
    from catseg_tpu_torch import configs

    cfg = getattr(configs, family)(compute_dtype=dt)
    cfg = configs.eval_preset(cfg) if batch is None else cfg.replace(batch_size=batch)
    return cut_depth(cfg) if dt == "float32" else cfg


def fusion_state(cfg):
    """The seeded train state of a fusion config on the card; Ver14's mask
    decoder made livelier ([29]), so its refined logits are O(1)."""
    from catseg_tpu_torch.train.loop import init_train_state

    state = init_train_state(cfg, seed=SEED)
    if cfg.fusion.mode == "sam_refine":
        livelier_sam_(state.model, SEED + 7)
    return state


def fusion_forward_inputs(cfg, T: int, seed: int):
    """[45]'s serving inputs: 2 random uint8 384^2 tiles and T random text
    features of the family's CLIP width, on the card."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (2, 384, 384, 3), generator=g).float()
    return images.cuda(), torch.randn(T, 1, cfg.clip.embed_dim, generator=g).cuda()


def fusion_forward(model, cfg, inputs, class_axis=None) -> torch.Tensor:
    """The family's serving forward: logits (Ver31) or refined logits (Ver14)."""
    with torch.no_grad():
        return model(*inputs, cfg, class_axis=class_axis)


def kept_sets(logits) -> list:
    """Per image, the classes whose planes are not all -100 (top-k kept)."""
    return [set(torch.nonzero(~(lg == -100.0).flatten(1).all(1)).flatten().tolist()) for lg in logits]


def fusion_fp32_step(cfg, images, targets, mesh=None):
    """One fp32 step of the seeded ``cfg`` on the card, over ``mesh`` where
    given: (loss, parameters after it, the gradients the update took, i.e.
    reduced over the ranks and before the clip), on the host."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.train.loop import class_tokens, make_train_step

    state = fusion_state(cfg)
    step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")), mesh=mesh)
    grads, update = {}, state.optimizer.step

    def keep_grads_and_update():
        grads.update({n: p.grad.detach().cpu().clone() for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return update()

    state.optimizer.step = keep_grads_and_update
    loss = step(state.model, images.cuda(), targets.cuda()).item()
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, step
    torch.cuda.empty_cache()
    return loss, params, grads


def grouped_checks(calls) -> dict:
    """{(kernel, dtype): (calls, max abs error, judged error)} of recorded
    kernel calls, each against its plain version on its own inputs."""
    from catseg_tpu_torch.kernels import selfcheck

    groups = {}
    for name, args in calls:
        groups.setdefault((name, args[0].dtype), []).append((name, args))
    return {(name, dt): selfcheck.check_calls(cs, dt)[name] for (name, dt), cs in groups.items()}


def rank_bf16_step(step, model, images, targets) -> dict:
    """A rank's bf16 step ([44], [45]): one counted step, 3 timed steps and
    the allocator's peak, and one more step whose every kernel call, forward
    and backward, is held against its plain version (:func:`grouped_checks`)."""
    from catseg_tpu_torch.kernels import _build, selfcheck

    img, tgt = images.cuda(), targets.cuda()
    torch.cuda.reset_peak_memory_stats()
    loss, launches = run_counted(lambda: step(model, img, tgt).item(), _build)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, img, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec = dict(bf16_loss=loss, launches=launches, ms=statistics.median(times), ms_all=times,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    with selfcheck.recorded_calls(backward=True) as calls:
        step(model, img, tgt)
    rec["checks"] = grouped_checks(calls)
    return rec


def fusion_forward_rank(axis, want_path: str) -> list:
    """[45]'s forwards on this rank of the mesh {1, 2}, per FUSION_FORWARD
    case: the fp32 output against one process's (``want_path``: kept sets
    equal, then max |d|), then bf16 at full depth: one counted
    forward, every kernel call of another against its plain version, ms a
    forward, the first input of the Swin pair's calls."""
    from catseg_tpu_torch.kernels import _build, selfcheck

    want = torch.load(want_path, weights_only=True)
    out = []
    for family in FUSION_FAMILIES:
        cases = [(i, T) for i, (f, T) in enumerate(FUSION_FORWARD) if f == family]
        cfg = fusion_cfg(family, "float32")
        model = fusion_state(cfg).model.eval()
        fp32 = {}
        for i, T in cases:
            got = fusion_forward(model, cfg, fusion_forward_inputs(cfg, T, SEED + T), axis).cpu()
            kept = kept_sets(got) == kept_sets(want[i])
            fp32[i] = (kept, (got - want[i]).abs().max().item() if kept else float("inf"), tuple(got.shape))
        del model
        torch.cuda.empty_cache()
        cfg = fusion_cfg(family, "bfloat16")
        model = fusion_state(cfg).model.eval()
        for i, T in cases:
            inputs = fusion_forward_inputs(cfg, T, SEED + T)
            fusion_forward(model, cfg, inputs, axis)                          # warm-up
            _, launches = run_counted(lambda: fusion_forward(model, cfg, inputs, axis), _build)
            with selfcheck.recorded_calls() as calls:
                fusion_forward(model, cfg, inputs, axis)
            checks = grouped_checks(calls)
            swin = [tuple(a[0].shape) for name, a in calls if name == "swin_block"]
            del calls
            ms = time_ms(lambda: fusion_forward(model, cfg, inputs, axis), reps=5, warmup=1)
            out.append({"family": family, "T": T, "fp32": fp32[i], "launches": launches, "checks": checks,
                        "swin_shapes": sorted(set(swin)), "ms": ms})
        del model
        torch.cuda.empty_cache()
    return out


def fusion_step_rank(axis, step_images, step_targets, images, targets, want_path: str) -> dict:
    """[45]'s steps on this rank of the mesh {1, 3}, per family: the fp32
    step at one crop against one process's (``want_path``): loss and
    parameter differences, the worst reduced gradient's max |d| / max |g|,
    a checksum of the parameters; then the bf16 step at 2 crops and full
    depth: one counted step, 3 timed steps and the allocator's peak, and one
    more step whose every kernel call is held against its plain version."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.train.loop import class_tokens, make_train_step

    want = torch.load(want_path, weights_only=True)
    out = {}
    for family in FUSION_FAMILIES:
        loss, params, grads = fusion_fp32_step(fusion_cfg(family, "float32", 1), step_images, step_targets, axis)
        w_loss, w_params, w_grads = want[family]
        if grads.keys() != w_grads.keys():
            raise AssertionError(f"[45] {family}: the ranks' step formed gradients for other tensors than one "
                                 "process's")
        worst_grad = max(((g - w_grads[n]).abs().max().item() / max(w_grads[n].abs().max().item(), 1e-30), n)
                         for n, g in grads.items() if w_grads[n].any() and not zero_by_symmetry(n))
        rec = {"d_loss": abs(loss - w_loss), "d_params": max((params[n] - p).abs().max().item()
                                                            for n, p in w_params.items()),
               "worst_grad": worst_grad, "checksum": [float(p.double().abs().sum()) for p in params.values()]}
        del params, grads
        cfg = fusion_cfg(family, "bfloat16", 2)
        state = fusion_state(cfg)
        step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")), mesh=axis)
        rec.update(rank_bf16_step(step, state.model, images, targets))
        del state, step
        torch.cuda.empty_cache()
        out[family] = rec
    return out


def class_mesh12_rank(step_images, step_targets, params_path: str, fusion_path: str) -> dict:
    """Phase 43 on one of two ranks sharing cuda:0 over gloo (mesh {1, 2}):
    the fp32 aggregator at each CLASS_FORWARD_T (logits and kept classes),
    then bf16: one counted forward each, every kernel call of another held
    against its plain version, ms a forward; then [44]'s fp32 step at T = 171,
    which does not divide over two ranks (the warning recorded); then [45]'s
    fusion forwards (:func:`fusion_forward_rank`)."""
    import warnings

    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.kernels import _build, selfcheck
    from catseg_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    axis = mesh.make_mesh(n_data=1, n_class=2)
    out = {"rank": mesh.rank(), "fp32": [], "bf16": []}
    # the parameters stay fp32 in either compute dtype: one seeded aggregator serves both
    agg = init_catseg_(CATSeg(eval_preset(vitb384(compute_dtype="float32"))), SEED).agg.cuda().eval()
    for dt in (torch.float32, torch.bfloat16):
        cfg = eval_preset(vitb384(compute_dtype=str(dt)[6:]))
        for T in CLASS_FORWARD_T:
            inputs = on_card(class_forward_inputs(T, SEED + T), dt)
            if dt == torch.float32:
                logits, kept = class_forward(agg, cfg, inputs, axis)
                out["fp32"].append((logits.cpu(), None if kept is None else kept.cpu()))
                continue
            class_forward(agg, cfg, inputs, axis)                      # warm-up
            _, launches = run_counted(lambda: class_forward(agg, cfg, inputs, axis), _build)
            with selfcheck.recorded_calls() as calls:
                class_forward(agg, cfg, inputs, axis)
            checks = selfcheck.check_calls(calls, dt)
            shapes = {name: tuple(args[0].shape) for name, args in calls}
            del calls
            ms = time_ms(lambda: class_forward(agg, cfg, inputs, axis), reps=5, warmup=1)
            out["bf16"].append({"T": T, "launches": launches, "checks": checks, "shapes": shapes, "ms": ms})
    del agg
    torch.cuda.empty_cache()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out["step"] = class_step_rank(class_step_cfg("float32", 1), step_images, step_targets, 2, params_path)
    out["warnings"] = [str(w.message) for w in seen if issubclass(w.category, UserWarning)]
    torch.cuda.empty_cache()
    out["fusion"] = fusion_forward_rank(axis, fusion_path)
    return out


def class_mesh13_rank(step_images, step_targets, params_path: str, images, targets, fusion_path: str) -> dict:
    """Phase 44 on one of three ranks sharing cuda:0 over gloo (mesh {1, 3},
    57 classes a rank): the fp32 step at one crop and cut depth (rank 0
    saves its parameters), then vitb384() in bf16 at 2 crops: one counted
    step, 3 timed steps and the allocator's peak, and one more step whose
    every kernel call, forward and backward, is held against its plain
    version: {(name, dtype): (calls, max abs error, judged error)}; then
    [45]'s fusion steps (:func:`fusion_step_rank`)."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank(), "step": class_step_rank(class_step_cfg("float32", 1), step_images, step_targets, 3,
                                                        params_path)}
    torch.cuda.empty_cache()
    cfg = class_step_cfg("bfloat16", 2)
    state = init_train_state(cfg, seed=SEED)
    axis = mesh.make_mesh(n_data=1, n_class=3)
    step = make_train_step(cfg, state.optimizer, class_tokens(class_names("coco")), mesh=axis)
    out.update(rank_bf16_step(step, state.model, images, targets))
    del state, step
    torch.cuda.empty_cache()
    out["fusion"] = fusion_step_rank(axis, step_images, step_targets, images, targets, fusion_path)
    return out


def judge_bf16_step(r: dict, need, what: str, smi) -> list:
    """Logs a rank's bf16 step record (:func:`rank_bf16_step`); returns what
    failed: a kernel of ``need`` never launched or never recorded, a kernel
    call outside its bound, a loss that is not finite."""
    from catseg_tpu_torch.kernels import selfcheck

    bad = []
    missing = [k for k in need if r["launches"][k] == 0]
    log(f"    rank {r['rank']} {what} bf16 step: loss {r['bf16_loss']:.6f}, {r['ms']:.1f} ms/step median of 3 (all "
        f"{[round(t, 1) for t in r['ms_all']]}; three ranks on one card), peak {r['peak_gib']:.2f} GiB; "
        f"launches {r['launches']}; on {smi}")
    bad += [f"rank {r['rank']} {what} bf16 step never launched {missing}"] if missing else []
    bad += [] if math.isfinite(r["bf16_loss"]) else [f"rank {r['rank']} {what} bf16 loss"]
    for (name, dt), (n, err, rel) in sorted(r["checks"].items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        bound = selfcheck.bound(name, dt)
        log(f"    rank {r['rank']} {what} step {name:16s} {str(dt)[6:]:8s} {n:3d} calls: max_abs_err {err:.3e} rel "
            f"{rel:.3e} (bound {bound:.1e})")
        bad += [] if rel <= bound else [f"rank {r['rank']} {what} step {name} {dt}"]
    unchecked = [k for k in need if not any(name == k for name, _ in r["checks"])]
    return bad + ([f"rank {r['rank']} {what} step calls never recorded {unchecked}"] if unchecked else [])


def fusion_judge(out: list, out3: list, smi) -> list:
    """Phase 45's readings from [43]'s ranks (the forwards, ``out``) and
    [44]'s (the steps, ``out3``), logged; returns what failed."""
    from catseg_tpu_torch.kernels import selfcheck

    bad = []
    for i, (family, T) in enumerate(FUSION_FORWARD):
        for r in out:
            rec = r["fusion"][i]
            kept, worst, shape = rec["fp32"]
            log(f"    rank {r['rank']} {family} T={T}: fp32 output {shape}, kept sets equal {kept}, max |d| against "
                f"one process {worst:.3e} (bound {CLASS_LOGIT_BOUND:.0e}); bf16 {rec['ms']:.2f} ms a forward (median "
                f"of 5, both ranks on one card), Swin pair inputs {rec['swin_shapes']}, launches {rec['launches']}; "
                f"on {smi}")
            bad += [] if kept and worst <= CLASS_LOGIT_BOUND else [f"rank {r['rank']} {family} T={T} fp32"]
            for (name, dt), (n, err, rel) in sorted(rec["checks"].items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
                bound = selfcheck.bound(name, dt)
                log(f"      {name:16s} {str(dt)[6:]:8s} {n:4d} calls: max_abs_err {err:.3e} rel {rel:.3e} (bound "
                    f"{bound:.1e})")
                bad += [] if rel <= bound else [f"rank {r['rank']} {family} T={T} {name} {dt}"]
            missing = [k for k in FUSION_LAUNCHES[family]
                       if rec["launches"][k] == 0 or not any(name == k for name, _ in rec["checks"])]
            bad += [f"rank {r['rank']} {family} T={T} never launched or recorded {missing}"] if missing else []
    for family in FUSION_FAMILIES:
        recs = [r["fusion"][family] for r in out3]
        equal = all(rec["checksum"] == recs[0]["checksum"] for rec in recs)
        for r, rec in zip(out3, recs):
            log(f"    rank {r['rank']} {family} fp32 step: loss |d| {rec['d_loss']:.2e} (bound "
                f"{FUSION_LOSS_BOUND:.0e}), parameters max |d| {rec['d_params']:.2e} (bound {FUSION_PARAM_BOUND:.0e}), "
                f"the reduced gradients' worst max |d| / max |g| {rec['worst_grad'][0]:.2e} ({rec['worst_grad'][1]}; "
                f"the attention k biases aside); ranks bit-equal {equal}")
            if not rec["d_loss"] <= FUSION_LOSS_BOUND or not rec["d_params"] <= FUSION_PARAM_BOUND or not equal:
                bad.append(f"rank {r['rank']} {family} fp32 step")
            bad += judge_bf16_step({**rec, "rank": r["rank"]}, FUSION_STEP_LAUNCHES[family], family, smi)
        bad += [] if len({rec["bf16_loss"] for rec in recs}) == 1 else [f"{family} bf16 losses differ between ranks"]
    return bad


def class_axis_phases(smi) -> None:
    """Phases 43, 44 and 45: class-axis model parallelism over gloo ranks
    sharing cuda:0 (a check of the code; one card reads no scaling)."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.kernels import selfcheck
    from catseg_tpu_torch.parallel import mesh
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    log(f"[43] class-axis forward over two gloo ranks sharing cuda:0 (mesh {{1, 2}}): the eval_preset(vitb384()) "
        f"aggregator at full width, 2 images of random CLIP features, T = {CLASS_FORWARD_T} (847: top-k to 256, "
        "128 a rank); fp32 against one process on the card, bf16 kernels against their plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = eval_preset(vitb384(compute_dtype="float32"))
    agg = init_catseg_(CATSeg(cfg), SEED).agg.cuda().eval()
    want = [class_forward(agg, cfg, on_card(class_forward_inputs(T, SEED + T), torch.float32))
            for T in CLASS_FORWARD_T]
    want = [(lg.cpu(), None if kept is None else kept.cpu()) for lg, kept in want]
    del agg
    # [44]'s reference: one process stepping the same crop at the same cut depth
    step_images, step_targets = synthetic_batch(1, CLASS_STEP_T, SEED + 5)
    cfg32 = class_step_cfg("float32", 1)
    state = init_train_state(cfg32, seed=SEED)
    start = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    one = make_train_step(cfg32, state.optimizer, class_tokens(class_names("coco")))
    want_loss = one(state.model, step_images.cuda(), step_targets.cuda()).item()
    want_params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, one
    torch.cuda.empty_cache()
    # [45]'s: one process's forwards and fp32 steps, each family's seeded model at cut depth
    t0 = time.perf_counter()
    fusion_want, fusion_steps = [None] * len(FUSION_FORWARD), {}
    for family in FUSION_FAMILIES:
        cfg = fusion_cfg(family, "float32")
        model = fusion_state(cfg).model.eval()
        for i, (f, T) in enumerate(FUSION_FORWARD):
            if f == family:
                fusion_want[i] = fusion_forward(model, cfg, fusion_forward_inputs(cfg, T, SEED + T)).cpu()
        del model
        torch.cuda.empty_cache()
        fusion_steps[family] = fusion_fp32_step(fusion_cfg(family, "float32", 1), step_images, step_targets)
    fusion_ref_s = time.perf_counter() - t0

    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        path2 = os.path.join(tmp, "params_2.pt")
        forward_path, step_path = os.path.join(tmp, "fusion_forward.pt"), os.path.join(tmp, "fusion_step.pt")
        torch.save(fusion_want, forward_path)
        torch.save(fusion_steps, step_path)
        del fusion_want, fusion_steps
        t0 = time.perf_counter()
        out = mesh.spawn(class_mesh12_rank, 2, step_images, step_targets, path2, forward_path, backend="gloo",
                         devices=["cuda:0", "cuda:0"], tmp_dir=tmp)
        wall = time.perf_counter() - t0
        for i, T in enumerate(CLASS_FORWARD_T):
            w_logits, w_kept = want[i]
            worst, kept_equal = 0.0, True
            for r in out:
                logits, kept = r["fp32"][i]
                if (kept is None) != (w_kept is None) or (kept is not None and any(
                        set(kept[b].tolist()) != set(w_kept[b].tolist()) for b in range(2))):
                    kept_equal = False
                    continue
                ref = w_logits
                if kept is not None:   # by class id: top-k may order tied classes apart
                    logits = torch.stack([logits[b, torch.argsort(kept[b])] for b in range(2)])
                    ref = torch.stack([w_logits[b, torch.argsort(w_kept[b])] for b in range(2)])
                worst = max(worst, (logits - ref).abs().max().item())
            log(f"    fp32 T={T}: logits {tuple(out[0]['fp32'][i][0].shape)} on both ranks, max |d logit| against "
                f"one process {worst:.3e} (bound {CLASS_LOGIT_BOUND:.0e}), kept sets equal {kept_equal}")
            if not kept_equal or not worst <= CLASS_LOGIT_BOUND:
                bad.append(f"fp32 T={T}")
        for r in out:
            for rec in r["bf16"]:
                T = rec["T"]
                for name, (n, err, rel) in rec["checks"].items():
                    bound = selfcheck.bound(name, torch.bfloat16)
                    log(f"    rank {r['rank']} bf16 T={T} {name:12s} {n:2d} calls, first input {rec['shapes'][name]}: "
                        f"max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e})")
                    if not rel <= bound:
                        bad.append(f"rank {r['rank']} T={T} {name}")
                need = ("corr_embed", "swin_block", "class_layer", "decoder")
                missing = [k for k in need if rec["launches"][k] == 0 or k not in rec["checks"]]
                bad += [f"rank {r['rank']} T={T} never launched {missing}"] if missing else []
                log(f"    rank {r['rank']} bf16 T={T}: {rec['ms']:.2f} ms a forward (median of 5, both ranks on one "
                    f"card, gloo gathers through the host); launches {rec['launches']}; on {smi}")
        log(f"    the two ranks' processes {wall:.1f} s from spawn to the last result, [45]'s forwards included")
        got2 = torch.load(path2, weights_only=True)

        log(f"[44] class-axis train step over gloo ranks sharing cuda:0: mesh {{1, 3}} at T = {CLASS_STEP_T} "
            f"({CLASS_STEP_T // 3} classes a rank); fp32 at one crop, CLIP cut (cut_depth), against one process; then "
            "vitb384() in bf16, 2 crops, every kernel call of a step against its plain version; and mesh {1, 2} at "
            "T = 171 (does not divide: the warning, every rank aggregates all 171), in [43]'s ranks")
        images, targets = synthetic_batch(2, CLASS_STEP_T, SEED + 6)
        path3 = os.path.join(tmp, "params_3.pt")
        t0 = time.perf_counter()
        out3 = mesh.spawn(class_mesh13_rank, 3, step_images, step_targets, path3, images, targets, step_path,
                          backend="gloo", devices=["cuda:0"] * 3, tmp_dir=tmp)
        wall3 = time.perf_counter() - t0
        got3 = torch.load(path3, weights_only=True)
    scale = max(1.0, max(float(p.abs().max()) for p in want_params.values()))
    warned = all(any(f"T={CLASS_STEP_T} not divisible by mesh class axis 2" in w for w in r["warnings"]) for r in out)
    for mesh_name, ranks, got in (("{1, 3}", out3, got3), ("{1, 2}", out, got2)):
        loss = ranks[0]["step"][0]
        d_loss = abs(loss - want_loss)
        worst = max(float((got[n] - want_params[n]).abs().max()) for n in want_params)
        equal = all(r["step"] == ranks[0]["step"] for r in ranks)
        moved = sum(not torch.equal(got[n], p) for n, p in start.items())
        log(f"    fp32 mesh {mesh_name}: loss {loss:.7f} vs one process {want_loss:.7f} (|d| {d_loss:.2e}, bound "
            f"1e-5); parameters max |d| {worst:.2e} (bound 1e-4 x max(1, max |p|) = {1e-4 * scale:.2e}); ranks "
            f"bit-equal {equal}; {moved} tensors moved")
        if not d_loss < 1e-5 or not worst <= 1e-4 * scale or not equal or moved == 0:
            bad.append(f"fp32 step {mesh_name}")
    log(f"    mesh {{1, 2}} warned on both ranks: {warned}")
    bad += [] if warned else ["no warning for T=171 over 2 class ranks"]
    need = ("corr_embed", "swin_block", "class_layer", "decoder", "swin_block_bwd", "class_layer_bwd", "decoder_bwd")
    for r in out3:
        bad += judge_bf16_step(r, need, "vitb384", smi)
    bad += [] if len({r["bf16_loss"] for r in out3}) == 1 else ["bf16 losses differ between ranks"]
    log(f"    the three ranks' processes {wall3:.1f} s from spawn to the last result, [45]'s included")
    log(f"[45] the fusion families on a class axis, in [43]'s and [44]'s ranks: fusion_ver31() at T = 847 (top-k to "
        "256, 128 a rank) and 150, fusion_ver14() (raw-corr proposals) at 150, on {1, 2}: the fp32 serving forward "
        "at cut depth against one process, bf16 at full depth with every kernel call against its plain version; "
        f"each family's train step on {{1, 3}} at T = {CLASS_STEP_T}: fp32 at one crop and cut depth against one "
        f"process, bf16 at 2 crops with every kernel call checked; one process's references {fusion_ref_s:.1f} s")
    bad += fusion_judge(out, out3, smi)
    if bad:
        raise AssertionError(f"class-axis phases: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384, vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.evaluation.miou import ConfusionAccumulator
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import _build, selfcheck

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"devices {torch.cuda.device_count()}  card: {smi}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s -> {lib}")

    log("[3] kernels vs plain versions at the slice's shapes (10 tiles, T=150; class layer also T=256)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {dt: check_kernels(dev, dt, selfcheck, _build) for dt in (torch.float32, torch.bfloat16)}
    for name in ("swin_block_bwd", "class_layer_bwd", "decoder_bwd", "mlp", "mlp@swin", "mlp@512", "corr_embed",
                 "corr_embed@C256", "corr_embed@E40", "corr_embed@E48", "linear_attention",
                 "linear_attention@D128", "window_attention@D128", "window_attention@C512",
                 "window_attention@D96", "window_attention@D256", "linear_attention@D96",
                 "linear_attention@D256"):
        c = checks[torch.bfloat16][name]
        what = "worst gradient" if name.endswith("_bwd") else "error"
        # bf16 on the tensor cores, but for window attention at 4 heads of 128
        # and at head dim 256, and linear attention past the tensor-core head dims
        unit = ("CUDA cores" if name in ("window_attention@C512", "window_attention@D256", "linear_attention@D96",
                                         "linear_attention@D256") else "tensor cores")
        log(f"    {name} bf16 ({unit}): kernel {c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.4f} ms, {what} {c['rel_err']:.2e} (bound {c['rel_bound']:.1e})")

    log("[4] sliding-window Predictor, default vitb384 eval preset (fused decoder), bf16, T=150")
    cfg = eval_preset(vitb384())
    names = class_names("ade150")
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (512, 683, 3), dtype=np.uint8),
              rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)]
    hws = np.array([im.shape[:2] for im in images], np.int32)
    canvas = (512, 683)
    pred.preds_sliding_batch(images, hws, canvas)          # warm-up (Triton JIT, cuDNN plans)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    missing = [k for k in _build.FORWARD if launches[k] == 0]
    if missing or any(launches[k] for k in _build.UNFUSED):
        raise AssertionError(f"the main path never launched {missing}, or launched an unfused stage's kernel")
    preds = check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) "
        f"on {smi}; {len(np.unique(preds.numpy()))} distinct labels")
    del pred
    torch.cuda.empty_cache()

    log("[4b] the same slice with the plain decoder, vitb384(fused_decoder=False), bf16, T=150")
    cfg_plain = eval_preset(vitb384(fused_decoder=False))
    pred = Predictor(build_catseg(cfg_plain, seed=SEED), cfg_plain, names)
    pred.preds_sliding_batch(images, hws, canvas)
    preds_plain, plain_launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {plain_launches}")
    if (plain_launches["decoder"] or any(plain_launches[k] for k in _build.UNFUSED)
            or not all(plain_launches[k] for k in _build.FORWARD if k != "decoder")):
        raise AssertionError("the plain-decoder path launched the decoder kernel or an unfused stage's, "
                             "or skipped another one")
    check_preds(preds_plain, canvas, len(names))
    ips_plain, med_plain = images_per_s(pred, images, hws, canvas)
    log(f"    {ips_plain:.3f} images/s with the plain decoder (median of 3 2-image runs, "
        f"{med_plain * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()

    log("[5] fp32 parity of the default configuration: GPU kernels vs the port on the CPU, 1 image, 20 classes, "
        "CLIP cut (cut_depth)")
    cfg32 = cut_depth(eval_preset(vitb384(compute_dtype="float32")))
    cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg32, names[:20])
    p_gpu, gpu_launches = run_counted(lambda: gpu_pred.probs_sliding_batch(images[1:]).cpu(), _build)
    p_cpu = Predictor(cpu_model, cfg32, names[:20], device="cpu").probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    agree = (p_gpu.argmax(-1) == p_cpu.argmax(-1)).float().mean().item()
    log(f"    max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}  "
        f"argmax agreement {agree:.5f}  kernel launches {gpu_launches}")
    if not d.max().item() < PROB_BOUND or min(gpu_launches[k] for k in _build.FORWARD) == 0:
        raise AssertionError("fp32 GPU slice disagrees with the CPU port, or skipped a kernel")
    del gpu_pred
    cpu_model32, p_cpu_sliding = cpu_model, p_cpu[0]      # for phase 16

    log("[6] top-k path: 847 ADE-full names (pad_len 256 kept), bf16, the same 2 images")
    names847 = class_names("ade847")
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names847)
    pred.preds_sliding_batch(images, hws, canvas)
    preds847, topk_launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {topk_launches}")
    if (topk_launches["class_layer"] == 0 or topk_launches["decoder"] == 0
            or any(topk_launches[k] for k in _build.UNFUSED)):
        raise AssertionError("the top-k path skipped the class-layer or decoder kernel, or launched an "
                             "unfused stage's")
    check_preds(preds847, canvas, len(names847))
    check_probs(pred.probs_sliding_batch(images), len(names847))
    ips847, med847 = images_per_s(pred, images, hws, canvas)
    log(f"    {ips847:.3f} images/s at T=847 (median of 3 2-image runs, {med847 * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()

    cfg16 = cut_depth(eval_preset(vitb384(compute_dtype="float32", pad_len=16)))
    cpu_model = init_catseg_(CATSeg(cfg16), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg16, names847[:40])
    cpu_pred = Predictor(cpu_model, cfg16, names847[:40], device="cpu")
    tiles = cpu_pred._inputs(images[1:])

    def kept(p, batch):
        with torch.inference_mode():
            lg = p.model(torch.cat([batch[0][:, :384, :384], batch[1]]).to(p.device), p.text_feats).cpu()
        return [set(torch.nonzero(~(lg[i] == -100.0).flatten(1).all(1)).flatten().tolist()) for i in range(2)]

    k_gpu, k_cpu = kept(gpu_pred, tiles), kept(cpu_pred, tiles)
    p_gpu = gpu_pred.probs_sliding_batch(images[1:]).cpu()
    p_cpu = cpu_pred.probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    log(f"    fp32 top-k parity (pad_len 16 of 40 classes): kept sets equal {k_gpu == k_cpu} "
        f"({[len(k) for k in k_gpu]} kept)  max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})")
    if k_gpu != k_cpu or any(len(k) != 16 for k in k_gpu) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 top-k path disagrees with the CPU port")
    del gpu_pred, cpu_pred, cpu_model

    log("[7] confusion matrix on the card vs numpy, phase 4's predictions")
    gt = np.random.RandomState(SEED + 1).randint(0, len(names), preds.shape).astype(np.int64)
    gt[np.random.RandomState(SEED + 2).rand(*gt.shape) < 0.1] = 255
    acc = ConfusionAccumulator(len(names), ignore_label=255)
    acc.update(preds.to(dev), torch.from_numpy(gt).to(dev))
    K = len(names)
    p_np = preds.numpy().astype(np.int64)
    want_cm = np.bincount((p_np * (K + 1) + np.where(gt == 255, K, gt)).ravel(),
                          minlength=(K + 1) ** 2).reshape(K + 1, K + 1)
    got_cm = acc.matrix()
    log(f"    {int(got_cm.sum())} pixels, matrix equal {np.array_equal(got_cm, want_cm)}, "
        f"mIoU {acc.metrics()['mIoU']:.3f} (random weights, random labels)")
    if acc.cm.device.type != "cuda" or not np.array_equal(got_cm, want_cm):
        raise AssertionError("device confusion matrix differs from the numpy bincount")

    log("[8] train step, vitb384() at full width (bf16, pooling 2x2, fused decoder), B=4, T=171, 384^2 crops")
    train_launches = train_step_phase(dev, smi, _build, vitb384(), _build.FORWARD + _build.BACKWARD,
                                      _build.UNFUSED)
    train_parity_phase(dev)

    full_launches, agg = full_attention_serving_phase(dev, smi, _build, images, hws, canvas, names)
    full_parity_phase(images, names)
    log("[12] train step, vitb384(attention_type='full') (bf16, pooling 2x2), B=4, T=171")
    train_step_phase(dev, smi, _build, vitb384(attention_type="full"),
                     [k for k in _build.FORWARD if k != "class_layer"] + ["mlp", "swin_block_bwd", "decoder_bwd"],
                     ("class_layer", "class_layer_bwd", "window_attention", "linear_attention"))
    stage_launches = stage_phase(dev, agg, _build)
    del agg
    torch.cuda.empty_cache()
    bf16_gate_phase(_build)
    whole_image_phase(smi, _build, images, names)
    single_image_parity_phase(_build, images[1], names[:20], cpu_model32, p_cpu_sliding)
    del cpu_model32
    routes_phase(dev, _build)
    host_data_phase(smi)
    eval_cli_phase(smi, _build, ips)
    tta_phase(smi, _build, names)
    train_cli_phase(smi, _build)

    tier_serving_phase(smi, _build, images, hws, canvas, names)
    tier_parity_phase(images[1], names[:20])
    log("[24] train step, vitl336() at full width (bf16, pooling 2x2, fused decoder), B=4, T=171, 384^2 crops")
    train_step_phase(dev, smi, _build, vitl336(), _build.FORWARD + _build.BACKWARD, _build.UNFUSED)
    converter_phase(smi, _build)

    ver31 = ver31_serving_phase(smi, _build, images, hws, canvas, names)
    ver31_parity_phase(images[1], names[:20])
    ver31_topk_phase(smi, _build, ver31, images, hws, canvas)
    del ver31
    torch.cuda.empty_cache()
    ver14_phase(smi, _build, images, hws, canvas, names)
    fusion_converter_phase(smi)
    ver31_train_phase(dev, smi, _build)
    ver14_train_phase(dev, smi, _build)
    fusion_train_parity_phase(dev)
    sam_tools_phase(smi, _build)
    visuals_phase(smi, _build)
    demo_phase(smi, _build)
    viz_attn_phase(smi, _build)
    export_phase(smi, _build)
    _, _, nccl_cm, harness_cm = nccl_world1_phase(smi, _build)
    shared_card_phase(smi, _build, nccl_cm, harness_cm)
    tile_shard_phase(smi, _build, images[1])
    mamba_phase(smi, _build)
    class_axis_phases(smi)
    # [46] hidden 256 (#3 at C = 256, #10 at head dim 64, #11 at 256 -> 1024 ->
    # 256, #12 at C = 256); [47] one head of 128 (#3 at C = 128, #8, #10 and
    # #12 at head dim 128, #11 at 128 -> 512 -> 128); [48] hidden 512 (#3 at
    # C = 512, #10 and #12 at 4 heads of 128, #11 at 512 -> 2048 -> 512)
    variant_serving_phase(dev, smi, _build, images, hws, canvas, names, "[46]", dict(hidden_dim=256),
                          "4 heads of 64", "hidden 256", "hidden 256", WIDE_KERNELS, WIDE_ABSENT)
    variant_serving_phase(dev, smi, _build, images, hws, canvas, names, "[47]", dict(num_heads=1),
                          "one head of 128", "one head", "hidden 128, one head", HEADS1_KERNELS, HEADS1_ABSENT)
    variant_serving_phase(dev, smi, _build, images, hws, canvas, names, "[48]", dict(hidden_dim=512),
                          "4 heads of 128", "hidden 512", "hidden 512", WIDE_KERNELS, WIDE_ABSENT)
    # [49] hidden 384 (#3 at C = 384, #10 at head dim 96 on the tensor cores,
    # #11 at 384 -> 1536 -> 384, #12 at head dim 96 on its CUDA-core path);
    # [50] one head of 256 (#10 and #12 at head dim 256 on CUDA cores)
    variant_serving_phase(dev, smi, _build, images, hws, canvas, names, "[49]", dict(hidden_dim=384),
                          "4 heads of 96", "hidden 384", "hidden 384", WIDE_KERNELS, WIDE_ABSENT)
    variant_serving_phase(dev, smi, _build, images, hws, canvas, names, "[50]", dict(hidden_dim=256, num_heads=1),
                          "one head of 256", "hidden 256 one head", "hidden 256, one head", WIDE_KERNELS,
                          WIDE_ABSENT)

    kernels = []
    for name, route, source, replaces in selfcheck.KERNELS:
        # each kernel's launches in the run of the path that drives it
        n = (full_launches[name] if name == "mlp" else stage_launches[name] if name in _build.UNFUSED
             else launches[name] if name in _build.FORWARD else train_launches[name])
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": n, **checks[torch.bfloat16][name]})
    phase_clock()
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        if _phase[0] is not None:   # main() did not reach its end: where the time went
            phase_clock()
            print("by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()), file=sys.stderr)
