#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Drives the port's sixteen main paths with random weights made from a seed,
and fails loudly if any phase fails:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every hand-written kernel (K1, K2 and K3), from csrc/, one nvcc
     per source, all started together, with ptxas's register report; a
     register spill fails the run.

Path 1, the restore server: GFPGANv1OCR at PRODUCTION_GFPGAN (256²) behind
`Restorer.restore_batch_u8` and `/Restore/`, `/RestoreConcat/`:

  3. K1 against its plain PyTorch version on the card at every (M, C) shape
     the path gives it (batch 1 and 16, plus a ragged and a scalar-path
     shape), f32 and bf16, with its device time (calls back to back), its
     plain version's, the least time the card could take, and both as the
     host issues them;
  4. main path: launch counts set to 0, then one restore at batch 1, 4 and
     16 and HTTP requests; K1 must launch exactly 39 times per forward;
  5. correctness: the net with K1 against the same net on K1's plain
     version (TF32 off, ≤1 LSB), and the card against the CPU on one image;
  6. throughput (imgs/s per batch, PyTorch's default TF32 settings) and a
     profiler breakdown of one batch-16 forward.

Path 2, the ×4 SR tile engine: SRVGGNetCompact (64 features, 32 convs),
int8 PTQ with pack-2 block-diagonal weights, tiles of 512 with a halo of 8,
8 tiles per engine call, behind `EngineRestorer` and `/SRx4/`:

  7. K2 against its plain version at each layer shape of an engine call
     (4 packed images of 528², Cin→Cout 6→128, 128→128, 128→96) in both
     epilogue modes, plus ragged shapes (the served 528 width, H = 1, tiles
     that cross images, Cout 160/192, sums of 2^22 and more that take the
     kernel's scalar epilogue): integer-exact; device times of the
     kernel and the plain version, the bound, and two library yardsticks
     (torch._int_mm on the im2col matrix, and the cuDNN bf16 conv of the
     packed bf16 path at the same shape);
  8. main path: counts set to 0, then `EngineRestorer` on a 1024×768 image
     and one POST to /SRx4/; K2 must launch exactly 34 times per engine
     chunk and K1 never;
  9. correctness (TF32 off): the chain on K2 against the chain on K2's
     plain version (int8 activations equal at every layer, bf16 output
     bit-equal), int8 against the packed bf16 path (span-normalized PSNR
     ≥ 30 dB), tiled against untiled for the float net (interior), and the
     card against the CPU on one pair of 64² tiles;
 10. throughput: ms per engine call and tiles/s for the int8 engine and the
     packed bf16 path, peak device memory, and a profiler breakdown of one
     int8 engine call.

Path 3, ESRGAN ×4: RRDBNet at RRDBNET_X4 (64 features, 23 blocks, grow 32)
behind `infer --arch rrdbnet --tile 512` and `Restorer.restore_tiled_u8`, its
packed, widened and int8 forms, and K3 behind the stage-conv probe:

 11. K3 against its plain version at the five widened stage shapes at 528²
     (bf16 and float32 out) and a ragged shape, with device times, the bound
     and each stage's share of it, cuDNN's bf16 conv, and K3 at 48×528 (one
     tile per block: a launch's fixed cost); then `probe_conv.main()`, K3's
     entry point, with the counts set to 0 before it and read after;
 12. K2's "bf16_deq" epilogue against its plain version at the five RRDB
     stage shapes at 528², one image and the ladder's batch of 4, and at
     ragged shapes, bit-equal, with device times for one image and
     torch._int_mm on the im2col matrix (the contraction alone) as the
     yardstick;
 13. main path: counts set to 0, then `infer.main(["--arch", "rrdbnet",
     "--tile", "512", ...])` on a 1024×768 PNG (4 tiles of 544²) and
     `restore_tiled_u8` on the same image, timed; the card against the CPU
     at full width and depth on a 64×48 image (TF32 off, ≤1 LSB);
 14. the `scripts/bench_rrdb.py` ladder at 528², 23 blocks: plain bf16,
     packed g=4, widened g=1/2/4 and widened int8 (K2, 345 launches per
     forward), tiles/s and peak memory, and a profile of the int8 forward;
 15. the int8 chain at 2 blocks: on K2 against K2's plain version at 528²
     (every stage input equal, output bit-equal), and against the float32
     forward at 256² (≥30 dB); the 23-block PSNR is printed.

Path 4, the product pipeline: `PlatePipeline` at its defaults (RetinaFace
Resnet18 at 224², two Restorer(PRODUCTION_GFPGAN) at 256²) behind
`process`, `process_batch` and `/Vehicle_Resolution_GFPGAN/`:

 16. the detector: Resnet18 at 224² on the card against the CPU (TF32 off;
     raw outputs within 1e-3·max(1, max|CPU|), NMS order, keep and valid
     equal in the kept 20), the other three backbones at batch 8 (also
     against the CPU), ms per detect call at batch 1 and 8 and NMS's share;
 17. main path: counts set to 0, then `process` on a 640×480 photo and
     `process_batch` on 16 in chunks of 8, on the host and the device
     geometry path, and one POST; K1 must launch 39 times per GFPGAN
     forward (two per image or chunk), K2 and K3 never;
 18. correctness (TF32 off, the quad pinned): device geometry against host
     geometry on the card (the thresholds of tests/test_serve.py), and the
     card against the CPU on each path (≤4 LSB max, ≤0.05 mean);
 19. throughput: images/s of `process_batch` in chunks of 8 on each
     geometry path, the "auto" choice, ms per request and its PNG encode,
     peak memory, and a profile of one chunk on each path.

Path 5, the exported engines and the dynamic-int8 mode: `torch.export`
artifacts (K1, K2 and K3 are the custom ops `irt::…`) behind
`EngineFaceRestorer`, `PlatePipeline(geo_engine=EngineGeoPipeline)`,
`EngineRestorer(engine_dir)` and `IRT_SR_ENGINE`, and
`Restorer(quant="dyn-int8")` at PRODUCTION_GFPGAN:

 20. export on the card through the exporters (`scripts/export_gfpgan.py`
     `build_engine`, `scripts/export_restorer.py` `build_engine`) into a
     temporary directory: the GFPGAN u8 engine at batch 32 in float32 and in
     dyn-int8 and at batch 1, the geometry engine at batch 8, the SR engine
     at the exporter's defaults with uint8 IO; each export's seconds, its
     round trip and its MiB;
 21. main path (TF32 off): counts set to 0, then each artifact loaded as a
     server loads it against the live object: the GFPGAN engines against
     `restore_batch_u8` (≤1 LSB, K1 39 per forward through the artifact),
     the geometry engine in `PlatePipeline` against the live device
     geometry (montage ≤1 LSB, one 2N forward per chunk), the SR artifact
     against `EngineRestorer.build` on a 1024×768 photo (bit-equal, K2 34
     per chunk, K1 never), one POST to /SRx4/ through IRT_SR_ENGINE and one
     to /Restore/ through `ServiceCore(restorer=EngineFaceRestorer)`;
 22. dyn-int8: the card against the CPU on one image and the uint8 path
     against its float path (≥ 30 dB, TF32 off; the dB against the float32
     Restorer is printed), imgs/s and peak MiB of float32, bf16 and
     dyn-int8 at batch 32 (`SPEED_BATCHES`), a profile of one batch-32 dyn-int8
     restore with the shares of `_int_mm`, of the im2col and quantize
     passes and of K1, and ms per call of the exported module against the
     eager Restorer at batch 32.

Path 6, the production GFPGAN GAN trainer: `train_pipeline` (`python -m
image_restoration_tpu_torch.train -opt configs/train_gfpgan_plate_256.yml`)
at the config's full width (GFPGANv1OCR 256², StyleGAN2Discriminator at
channel multiplier 1, random VGG19 taps), batch 4, on seeded synthetic
plates, the degradation on the card inside each step:

 23. the degradation's apply half on the card against the CPU at the same
     drawn parameters (bs 4, 256²): each stage and the chain (median's
     8-bit levels bit-equal, float stages ≤1e-5, JPEG and the
     uint8-quantized chain within 2 levels on ≥99% of values), and its ms
     per batch at bs 4 and 16;
 24. one full-width G+D step and one R1 step with K1's kernel against the
     same with K1's plain version (same weights, batch, noise, degradation
     parameters; TF32 off): every loss within 1e-5 relative, G and D
     gradients within 1e-4 of max|grad| (1e-4 of elements to 1e-3); K1 84
     launches per G+D step and 15 per R1 step;
 25. the tiny config's (32²) step pieces on the card against the CPU, same
     tolerances;
 26. main path: counts set to 0, then `train_pipeline` on the production
     config with --force_yml (32 iterations, R1 at 16 and 32, validation
     and a checkpoint at 32), counts read (K1 exactly 32·84 + 2·15 + the
     validation forwards' 39 each, K2 and K3 never); every loss finite;
     `net_g_32.pth` served by `Restorer(ckpt_path=...)` (≤1 LSB against the
     trained EMA G) and one POST /Restore/ through `ServiceCore`;
 27. s per step (median of steps 5-16, run as a training loop runs them,
     with no synchronize between steps), trained imgs/s, the R1 step's ms,
     peak MiB and TFLOP/s against `analytic_gfpgan_flops` at bs 4;
 28. where one bs-4 step's device time goes: a profile of
     `optimize_parameters` for the device-busy share, the device time of
     each of its `gfpgan.*` ranges, the FIR depthwise convs, K1's forward
     launches, K1's PyTorch-op backward and the VGG forward.

Path 7, the SR trainers: `train_pipeline` on configs/train_qat_srvgg_x4.yml,
train_distill_rrdb_to_srvgg.yml and train_esrgan_x4.yml as written (full
widths; synthetic seeded images in a temp dir, cut to 32 or 16 steps with
--force_yml; random VGG taps, a seeded RRDBNet-23 teacher `.pth`), the
Real-ESRGAN chain on the card, the int8 engine from the QAT checkpoint, and
`test.py`:

 29. the Real-ESRGAN degradation's apply half on the card against the CPU
     at one set of drawn parameters (bs 16, 256²), each stage on the same
     input (float stages ≤1e-5, JPEG and the chain within 2 levels on ≥99%
     of values), and its ms per batch;
 30. each SR trainer's tiny step (QAT SRVGG, distillation, ESRGAN with the
     VGG-style D) on the card against the CPU, TF32 off: losses within
     1e-5 relative, gradients within 1e-4 of max|grad|, D's refreshed
     running statistics within 1e-5;
 31. QAT: 32 steps (SRVGG 64×32, gt 256, bs 16), its ckpt_32.pth built into
     the int8 engine (tile 512, halo 8, 8 tiles per call, pack 2, uint8 IO)
     and served with the counts at 0 (EngineRestorer on 1024×768 and POST
     /SRx4/: K2 exactly 34 per engine call); the engine bit-equal to the
     same chain on K2's plain version, ≥ 35 dB against qat_srvgg_forward at
     the exported scales; s/step, imgs/s, busy share, peak MiB, tiles/s;
 32. distillation: 16 steps with the bf16 RRDBNet-23 teacher, the teacher
     bit-unchanged, s/step;
 33. ESRGAN ×4: 16 steps (RRDBNet-23, gt 128, bs 16, conv5_4 perceptual,
     vanilla GAN), then test.py with configs/test_esrgan_x4.yml on the run's
     net_g_16.pth; s/step, imgs/s, busy share, PSNR/SSIM.

Path 8, the StyleGAN2 family: FUSE_UP / FUSE_DOWN on the restore, and
`train_pipeline` (`python -m image_restoration_tpu_torch.train -opt
configs/options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml`) at the
config's full width (StyleGAN2Generator 256², 512 style features, 8 MLP
layers, channel multiplier 2; the D at 2; batch 3) with style mixing, R1,
the path-length penalty through K1's double backward, and the EMA G sampled
from its checkpoint:

 34. the restore at PRODUCTION_GFPGAN in the four FUSE settings (off, up,
     down, both): each flagged forward against the unflagged one (TF32
     off; float32 ≤1 LSB and ≤2e-4·max|y|, dyn-int8 ≥30 dB), K1 39 per
     forward in each; device ms of a bs-16 forward, imgs/s at bs 16 and
     32, and the FIR depthwise convs' and the fused ops' shares of a bs-16
     forward's device time;
 35. the tiny config's (32²) D+G, R1 and path-length pieces on the card
     against the CPU with one style and with two (losses ≤1e-5 relative,
     gradients ≤1e-4 of max|grad|, mean_path_length ≤1e-5), and one
     full-width path-length step with K1 against plain K1;
 36. main path: counts set to 0, then `train_pipeline` on the config with
     --force_yml (the disk backend over 16 seeded 256² images, 32
     iterations, a checkpoint at 32), counts read (K1 exactly 21 per G
     forward with one code, 29 with two, 15 per D forward, from the
     model's own draws; K2 and K3 never); every loss finite; `net_g_32.pth`
     in a fresh StyleGAN2Generator samples what the trained EMA G samples
     at truncation 0.7 around `mean_latent(4096)`;
 37. s per step (median of steps 5-16, no synchronize between steps),
     imgs/s and peak MiB at bs 3, the R1 and path-length steps' ms,
     and the device-busy share of a profiled bs-3 step with K1's forward
     and its PyTorch-op backward.

Path 9, the char-component discriminators and the identity loss:
`train_pipeline` on configs/train_gfpgan_plate_256x64_component.yml as
written (GFPGANv1OCR 256x64, StyleGAN2Discriminator at channel multiplier
1, the ten char Ds as one grouped FacialComponentDiscriminator, batch 4)
and on configs/train_gfpgan_plate_256_identity.yml (a random frozen
IResNet18), on seeded synthetic plates and char boxes:

 38. K1 against its plain version at every (M, C) of a pass of the ten
     char Ds at bs 4 (f32: 4·64²×640, 4·32²×1280 twice, 4·16²×2560 twice),
     with device times and the bound; `roi_align` card vs CPU (forward
     ≤1e-6, gradient ≤1e-5 of max|grad|); the tiny (32²) component +
     identity step's pieces card vs CPU, and one full-width G+D and R1
     step of the component config with K1's kernel against the same on
     K1's plain version (TF32 off; losses ≤1e-5 relative, gradients ≤1e-4
     of max|grad|, 1e-4 of elements to 1e-3); K1 exactly G + 3·D + 20 + D
     launches, G and D counted on the nets at 256x64;
 39. main path: counts set to 0, then 32 iterations of the component
     config (R1 at 16 and 32, validation and a checkpoint at 32), counts
     read (K1 exactly 32·(G + 3·D + 20) + 2·D + the validation forwards,
     K2 and K3 never); every loss finite, every char D moved;
     --auto_resume from ckpt_32.pth restores the char Ds and their Adam
     bit-equal; then 16 iterations of the identity config, counted
     likewise: l_identity finite, the IResNet bit-unchanged;
 40. s per step (median of steps 5-16, no synchronize between steps),
     imgs/s and peak MiB of both configs at bs 4; from a profiled step of
     each, the device-busy share and the device ms under the forward
     ranges of roi_align, the char Ds and the IResNet; their forward +
     backward timed alone at the step's shapes.

Path 10, the plate detector's trainer: `python -m
image_restoration_tpu_torch.detect.train` (RetinaFace Resnet18 at 224²,
batch 24, the cfg's batch and JAX's convergence recipe; SGD with momentum,
weight decay and the ×0.1 steps; BatchNorm in train mode; the MultiBox
matching and loss batched on the card), its `.pth` served by
`PlateDetector` and `PlatePipeline`, `eval_detector` and
`detector_convergence`:

 41. one mobilenet0.25 step at 64², bs 2, card vs CPU (TF32 off): matched
     labels equal, loc and landmark targets ≤1e-6 of max|CPU|, losses
     ≤1e-5 relative, BatchNorm statistics ≤1e-5 of
     max(1, max|CPU|), parameters within JAX's DP bound of 5e-3;
 42. main path: counts set to 0, then the CLI on a label.txt tree of 48
     seeded synthetic scenes for 3 epochs, resumed with --resume_epoch 3
     for a fourth, its Resnet18_final.pth loaded strictly by
     `PlateDetector(ckpt_path=…)`, a `PlatePipeline` on it serving one
     photo, `eval_detector` on 4 photos; counts read (K1 exactly 78: two
     GFPGAN forwards; K2 and K3 never);
 43. `detector_convergence` at its defaults (1500 iterations, decay at
     70%, 16 held-out scenes made on the card): trained top-1 mean IoU ≥
     0.90 and detection rate 1.0, the random-init scores beside them;
 44. s per step (median of steps 5-16, no synchronize between steps),
     imgs/s, peak MiB, and a profiled step's device-busy share with the
     net's forward and the matching + loss forward.

Path 11, HiFaceGAN: `train_pipeline` on
configs/options/train/HiFaceGAN/train_hifacegan.yml as written (HiFaceGAN
num_feat 48 at 512², the multi-scale D, VGG19 perceptual, lsgan, ×10
feature matching, batch 1) on 8 seeded 512² pairs, then both HiFaceGAN test
configs:

 45. the tiny (num_feat 8, 64²) G and D losses and gradients card vs CPU
     (TF32 off; losses ≤1e-5 relative, gradients ≤1e-4 of max|grad|, or,
     where float32 itself holds them only to ≈4e-3 (the LIP encoder), the
     card within PATH_F64_FACTOR times the CPU float32's distance from a
     float64 CPU run);
 46. main path: counts set to 0, then 32 steps (a checkpoint and
     validation at the end) and test.py with test_hifacegan.yml and
     test_hifacegan_woGT.yml on net_g_32.pth; counts read (no kernel of
     the port on this path);
 47. s per step (median of steps 5-16), imgs/s, peak MiB and a profiled
     step's device-busy share.

Path 12, the IO backends and the metrics: the StyleGAN2 config as written
(its `io_backend: {type: lmdb}` included) trained on an lmdb the port
builds, that lmdb's InceptionV3 statistics, and the trained EMA G's FID
against them (`calculate_fid_stats_from_datasets`,
`calculate_stylegan2_fid`, `calculate_fid_folder`), random Inception and
VGG16 weights:

 48. 2304 seeded 256² PNGs, an lmdb by `make_lmdb_from_imgs` and a pak by
     the `create_pak` CLI; every key read back bit-equal to its PNG's bytes
     through the lmdb, the pak (its native reader, built with g++) and the
     disk backends; FFHQDataset items equal across the three; images/s
     through FFHQDataset and the DataLoader at bs 64 per backend;
 49. card vs CPU (TF32 off): InceptionV3 features at 299² of 4 images
     (≤1e-4 of max|CPU|), the LPIPS VGG16 distance of 4 pairs at 256²
     (≤1e-4 relative), `calculate_fid` of the card's features against the
     CPU's (≤1e-3 of trace(sigma)); a bs-16 G sample at 256² (512 style
     features, channel multiplier 2) on K1 against K1's plain version
     (≤1e-5 of max|y|, K1 21 launches), and its Inception features through
     the net's own 299² resize against JAX's resize-first path (≤1e-6 of
     max|f|);
 50. main path: counts set to 0, then `train_pipeline` on
     train_StyleGAN2_256_Cmul2_FFHQ.yml with only `dataroot_gt` (the lmdb),
     16 iterations and a checkpoint at 16 cut; the statistics CLI over the
     lmdb (2304 images, bs 64); `calculate_stylegan2_fid` of net_g_16.pth
     (2304 samples, bs 16, truncation 0.7); `calculate_fid_folder` of the
     source PNGs against the lmdb's statistics, ≈ 0 (≤1e-3 of
     trace(sigma)): both paths feed Inception RGB in [0, 1]; counts read
     (K1 exactly the training's forwards from the model's own draws plus
     8 + 144·21 for the FID, K2 and K3 never), every FID finite;
 51. the LPIPS, NIQE and PSNR/SSIM CLIs on 16 pairs; G samples/s at bs 16,
     InceptionV3 images/s at bs 64, the FID run's wall for 2304 samples,
     and the device-busy share of one profiled sample + extract batch.

Path 13, the image zoo and the data preparation that feeds it: the
MATLAB-bicubic sets and DIV2K sub-images made by the port's scripts on
2040×1356 photos, `train_pipeline` on the EDSR, RCAN and SRResNet_SRGAN
option files as written (but for dataroots and absent pretrained paths),
`test.py` on their test files, and RIDNet and DFDNet from reference-layout
`.pth` files; no kernel of the port runs on this path:

 52. 8 seeded 2040×1356 photos as DIV2K_train_HR; `generate_bicubic` on
     the card (mod 12): LR ×2/×3/×4 of all 8 named the DIV2K way
     (0001x4.png), GTmod12 and LRbicx2/3/4 of the first 2 (the test sets);
     `extract_subimages` (HR 480/240, X2 240/120, X3 160/80, X4 120/60):
     40 sub-images per image and scale, every GT sub-image's LQ partner
     under `filename_tmpl: '{}'`; `imresize` card vs CPU (≤1e-5 of
     max|CPU|, PNGs within one level);
 53. card vs CPU (TF32 off) at the configs' full widths on a 2 × 48² LR
     batch: EDSR-L ×4 (256 features, 32 blocks), EDSR-M ×3, RCAN 10×20 ×4,
     MSRResNet ×2/×3/×4, RIDNet (64, 4 EAMs), ≤1e-4 of max|CPU|; DFDNet at
     512² with four part boxes and a seeded K = 64 dictionary; a tiny
     SRModel EDSR step (losses ≤1e-5 relative, gradients ≤1e-4 of
     max|grad|);
 54. main path: counts set to 0, then 8 steps each of train_EDSR_Lx4.yml
     (bs 16, gt 192), train_RCAN_x2.yml (bs 16, gt 96, with
     `network_g:upscale=2`: the file ships upscale 4 at scale 2),
     train_MSRResNet_x4.yml and train_MSRGAN_x4.yml (random VGG19 taps),
     a checkpoint and a validation on the made Set5 at 8; test.py on
     test_EDSR_Lx4.yml, test_MSRResNet_x4.yml and _woGT (the runs'
     net_g_8.pth) and test_RCAN.yml (×4: a seeded RCAN ×4 `.pth`); RIDNet
     and DFDNet at 512² from `.pth` files written here (DFDNet's with
     spectral-norm triples, and its dictionary); every PSNR finite, K1, K2
     and K3 counted 0;
 55. EDSR-L's and RCAN's s per step (median of steps 5-8), imgs/s and
     peak MiB and the device-busy share of a profiled step; test.py
     images/s; RIDNet's and DFDNet's ms per 512² forward.

Path 14, video: the REDS, Vid4 and Vimeo-90K layouts made on the card,
`train_pipeline` on the EDVR-L, BasicVSR, IconVSR and VideoRecurrentGAN
REDS configs, `test.py` on five video test configs, and `VideoPipeline`
on a video file; no kernel of the port runs on this path:

 56. 4 clips of 15 720×1280 GT frames (a seeded scene moving sub-pixel)
     with ×1/4 LQ by `imresize`, the same cut to 5 frames (the test
     set), a 5-frame validation clip, a Vid4-style 352×288 clip of 7
     (LQ, and LQ bicubic-upscaled for TOFlow), 2 Vimeo septuplets, their
     meta-info lists by `scripts/generate_meta_info.py` and a regroup by
     `scripts/regroup_reds_dataset.py`; a 640×480 mp4v video of 48 frames;
 57. card vs CPU (TF32 off): the modulated deformable conv at EDVR-L's
     shapes (128 channels, 8 groups, 64² and 180×320, offsets ±8 px) and
     `flow_warp` (64 channels, 180×320, both paddings), outputs and
     gradients within 1e-4; SpyNet, EDVR-L, EDVR-M, BasicVSR, IconVSR,
     DUF-52 and TOFlow at their configs' widths within 1e-4 of max|CPU|;
 58. main path: counts set to 0, then 8 steps each of the four REDS train
     configs (bs 4, gt 256; `tsa_iter` and `fix_flow` cut to 4: below them
     only `fusion.*` moved, `spynet.*`/`edvr.*` stayed bit-unchanged), as
     written but for dataroots, meta-info files, the SpyNet/EDVR/pretrained
     paths and the iteration cuts (each logged); s per step (median of
     steps 5-8 of the run itself), clips/s, peak MiB; a profiled EDVR-L
     and IconVSR step's busy share and the DCN's and warps' shares; test.py
     on
     test_EDVR_L_x4_SR_REDS.yml and test_BasicVSR_REDS.yml (the trained
     nets), test_BasicVSR_Vimeo90K_BIx4.yml, test_DUF_official.yml and
     test_TOF_official.yml (seeded `.pth` files): frames/s and PSNR;
 59. `VideoPipeline` (Resnet18 224², batches of 4) on the video: frames/s,
     tracks, the detector's share of the wall; K1, K2 and K3 counted 0.

Path 15, the last modules of the port: `Restorer` over every single-image
arch, the OCR masks in the GAN trainer, the FLOP counter, the profiler,
the restoration helper, the multi-device code in a world of one (the
card has one H100; larger worlds run on the CPU in
tests/test_torch_parallel.py), and the device metrics and resize modes:

 60. `Restorer` over GFPGANv1 (BasicSR's 512 options), MSRResNet ×4,
     EDSR-L ×4, RCAN 10×20 ×4, RIDNet, SPADEGenerator and HiFaceGAN at
     their configs' widths on seeded inputs at their configured sizes:
     card vs CPU on `restore_batch_u8` (TF32 off, ≤1 LSB), ms per call at
     bs 1, and EDSR-L ×4's `restore_tiled_u8` on a 1024×768 photo;
 61. the mask apply halves card vs CPU at the same draws (bit-equal), then
     main path: counts set to 0, `train_pipeline` on
     configs/train_gfpgan_plate_256.yml with the train set overridden to
     OCRDegradationDataset and `random_mask: true` (16 steps at bs 4, R1
     at 16), K1 exactly 16·84 + 15 + the validation forwards' 39 each;
     s per step and the masked share of the batch;
 62. `count_flops` of a bs-16 PRODUCTION_GFPGAN forward on the card beside
     `analytic_gfpgan_flops`, and the forward's counted TFLOP/s;
 63. `trace_training_window` of 3 GAN steps: the Chrome trace holds the
     three `train_step_*` spans and CUDA kernels;
 64. main path: counts set to 0, `RestorationHelper` on a 640×480 photo
     with the calibrated Resnet18 detector (2 detections kept) and a
     PRODUCTION_GFPGAN restorer, K1 exactly 39 per restored crop; the same
     detections restored and pasted on the CPU (montage ≤4 LSB max, ≤0.05
     mean);
 65. `init_dist("nccl")` in a world of one: a GAN + R1 step through the
     collectives bit-equal to the step without a process group,
     `spatial_sharded_apply` against the direct forward (interior ≤1e-5 of
     max|y|), `Restorer(data_parallel=1)` bit-equal to `Restorer`;
 66. `psnr_batch` / `ssim_batch` on a seeded 16 × 256² batch and `resize`
     at `area` (1024×768 → 256×192) and `bicubic` (256×64 → 1024×256),
     card vs CPU (TF32 off, 1e-5 relative; the resizes of max|CPU|); K1,
     K2 and K3 counted 0.

Path 16, training evidence: the port's counterparts of the JAX scripts
that show its trainers learn (`scripts/train_convergence.py`,
`gan_ablation.py`, `qat_distill.py`, `distill_e2e.py`,
`gfpgan_longrun.py`), at full width on seeded synthetic plate scenes,
each phase with the counts set to 0 just before it. Phases 67 and 70,
and phase 71, run in two processes of their own (this script with
`--phase`), started as the path starts, beside phases 68 and 69: the
steps are bound by the host, and the card serves all three:

 67. SR convergence (SRVGG ×4, f32, bs 8, 300 iterations): finite losses,
     the better head at least 10 dB over iteration 0, no kernel launched;
 68. GFPGAN convergence (the production trainer, f32, bs 8, 200
     iterations): the better head at least 3 dB over iteration 0; K1
     exactly 84 a G+D step, 15 an R1 step and 39 a validation forward;
 69. the GAN-vs-L1 ablation (2 × 50 iterations, bs 4): the arms start
     bit-equal and see bit-equal first three LQ batches, stay finite, and
     each arm's better head ends above its iteration 0; K1 as counted;
 70. QAT against PTQ at w8a8 (600 iterations an arm, bs 8), both scored
     through the served int8 engine: |QAT − PTQ| ≤ 0.3 dB, each int8 arm
     within 0.5 dB of the float arm, K2 34 a call;
 71. a short distillation (a 2-block RRDB teacher, students 100
     iterations an arm): the distilled arm does not diverge, its int8 gap
     comes through K2 (34 launches), K2 exactly 34 a call over the scoring
     call and the serving rate's 21; then the GFPGAN long run at recipe
     scale 2000 (100 bf16 iterations across both lr milestones and the
     pyramid removal): the lr and the pyramid weight each step used equal
     the schedule at each crossing, the `torch.export` engine of the
     trained EMA round-trips at ≥ 60 dB, and K1 is exactly 84 a step, 15
     an R1 step and 39 a forward (the validations, NIQE, the snapshot
     against the final EMA and the export's three).

To make room for paths 14-16, throughput repetitions of earlier paths were
cut (`CUTS`, logged first); no correctness comparison, kernel-vs-plain
check or launch-count assertion was cut.

Each path's seconds are printed as it ends. The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists the kernels as
JSON. The script puts its own directory first on sys.path and works from
there (the configs' paths are relative to it), so it runs from any working
directory; without a GPU, or without the port beside this file, it exits
non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from unittest import mock

import numpy as np
import torch

# the port lies beside this file: import it from any working directory
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, CUDA cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM, bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12    # H100 SXM, int8 tensor cores, dense
K1_LAUNCHES_PER_FORWARD = 39
# the SR engine at the JAX exporter's defaults (scripts/export_restorer.py)
SR = dict(num_feat=64, num_conv=32, upscale=4, tile=512, halo=8, batch=8)
K2_LAUNCHES_PER_CALL = SR["num_conv"] + 2
SR_GATE_DB = 30.0           # int8 vs packed bf16, bench.py's serving gate
RECEPTIVE_RADIUS = SR["num_conv"] + 2  # 3×3 convs, in input pixels
K1_OPS_PER_ELEMENT = 4      # add, compare, two multiplies
# device_time_ms: calls per window (at most 6 launches each, well inside the
# CUDA launch queue) and the sleep that holds the stream meanwhile (about
# 20 ms on an H100, several times what the host takes to enqueue a window)
HOLD_CALLS = 50
HOLD_CYCLES = 40_000_000
ROUTE_METHODS = {"/Restore/": "restore", "/RestoreConcat/": "restore_concat"}


# depth cut from earlier paths to make room for paths 14 and 15:
# throughput repetitions only; every correctness comparison,
# kernel-vs-plain check and launch-count assertion stays
CUTS = (
    "path 5, phase 22: dyn-int8/float32/bf16 imgs/s at bs 1 and 32 (bs 8 "
    "timing dropped)",
    "path 6, phase 27: GAN step timing at bs 4 only (the bs-16 rerun "
    "dropped)",
    "path 8, phase 34: FUSE timings in 'off' and 'both' (all four settings "
    "still checked)",
    "path 8, phase 37: StyleGAN2 step timing at bs 3 only (the bs-24 "
    "rerun dropped)",
    "path 12, phase 48: loader imgs/s at bs 64 only (bs 3 dropped)",
    "path 9, phase 40: the identity config's 32 timed steps (its profile "
    "stays)",
    "path 13, phases 52/54: test sets of 2 DIV2K-size images (were 4)",
    "path 13, phase 55: step timings of EDSR-L and RCAN only (MSRResNet and "
    "MSRGAN dropped)",
    # to make room for path 15
    "path 14, phase 58: a profiled step of EDVR-L only (IconVSR's 15-frame "
    "recurrent profile dropped; its s/step, clips/s and peak MiB stay)",
    "paths 6-11, phases 27, 31, 37, 40, 44, 47: every re-timed training "
    "loop 16 steps, the median of steps 5-16 (were 32 and 5-32)",
    "path 13, phases 52/54: test sets of 1 DIV2K-size image (were 2)",
    "path 5, phase 22: float32/bf16/dyn-int8 imgs/s at bs 32 only (bs 1 "
    "dropped)",
    "path 8, phase 34: FUSE 'off'/'both' imgs/s at bs 16 and 32 (bs 1 "
    "dropped)",
    "path 3, phase 14: the ladder's medians of 2 int8 / 3 float calls (were "
    "3 / 5)",
    "path 12, phase 51: G samples/s over 10 calls, Inception images/s over "
    "5 (were 20 / 10)",
    # to make room for path 16
    "path 14, phase 58: 8 steps of each video train config, tsa_iter and "
    "fix_flow at 4, the median of steps 5-8 (were 16, 8 and 5-16)",
    "path 14, phase 58: test clips of 5 frames (were 10)",
    "path 13, phases 54-55: 8 steps of each zoo train config, the median of "
    "steps 5-8 (were 16 and 5-16)",
    "path 12, phase 48: loader imgs/s over 128 images a backend (were 512)",
    "path 5, phase 22: the bs-1 GFPGAN artifact's host-cost timing (its "
    "export and round trip stay; the bs-32 artifact's timing stays)",
    "path 8, phases 34/37: a profile dropping K1 events is taken again "
    "once, not twice",
)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(*args):
    print(*args, flush=True)


# ----------------------------------------------------------------- helpers

def plate_image(h, w, seed):
    """A synthetic licence-plate-like BGR uint8 image."""
    import cv2
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 215, np.uint8)
    cv2.rectangle(img, (2, 2), (w - 3, h - 3), (20, 20, 20), max(1, h // 40))
    text = "".join(rng.choice(list("0123456789ABCDEFGHKLMN"), 7))
    scale = h / 45.0
    cv2.putText(img, text[:3] + "-" + text[3:], (w // 12, int(h * 0.68)),
                cv2.FONT_HERSHEY_SIMPLEX, scale, (15, 15, 15),
                max(1, int(scale * 2.5)))
    img = cv2.GaussianBlur(img, (0, 0), 1.2)
    noise = rng.normal(0, 8, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def scene_image(h, w, seed):
    """A synthetic RGB uint8 street-like scene: a smooth colour field, a few
    flat shapes with hard edges, a licence plate, blur and sensor noise."""
    import cv2
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.random((h // 64 + 2, w // 64 + 2, 3)).astype(
        np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img * 200 + 30, 0, 255).astype(np.uint8)
    for _ in range(12):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        size = int(rng.integers(h // 16, h // 4))
        if rng.random() < 0.5:
            cv2.rectangle(img, (x0, y0), (x0 + size, y0 + size // 2), color,
                          -1)
        else:
            cv2.circle(img, (x0, y0), size // 2, color, -1)
    ph, pw = h // 6, h // 2
    y0, x0 = h // 2, w // 3
    img[y0:y0 + ph, x0:x0 + pw] = plate_image(ph, pw, seed)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def bf16_ulp(v):
    """One bf16 ulp of each value of v (float32)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def _warm_up(fn, arg_sets):
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()


def host_time_ms(fn, arg_sets, iters):
    """Mean ms per call as the host issues `iters` calls, cycling through
    `arg_sets`, launch path included (CUDA events; warm-up first)."""
    _warm_up(fn, arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, arg_sets, iters, calls=HOLD_CALLS,
                   cycles=HOLD_CYCLES):
    """Mean device ms per call over `iters` calls run back to back.

    In windows of `calls` calls, a sleep kernel of `cycles` holds the
    stream while the host enqueues the window, so the CUDA events time the
    device alone and not the host's launch path, which dominates small
    calls. A window whose sleep ended before the host finished is timed
    again; the run fails after three."""
    _warm_up(fn, arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for first in range(0, iters, calls):
        for _ in range(3):
            torch.cuda._sleep(cycles)
            start.record()
            for i in range(first, min(iters, first + calls)):
                fn(*arg_sets[i % len(arg_sets)])
            end.record()
            held = not start.query()
            end.synchronize()
            if held:
                total += start.elapsed_time(end)
                break
        else:
            raise SystemExit("chip_smoke: FAILED: the host took longer to "
                             "enqueue a window of calls than the sleep that "
                             "held the stream, 3 times")
    return total / iters


def _kernel_events(prof):
    """(device ms, count, name) of every CUDA kernel/memcpy in a profile."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        rows.append((t / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_call(fn, kernel_key, want, tries=3):
    """torch.profiler (CPU and CUDA) over one fn() ending in a synchronize:
    (wall ms, device kernel events, launches of the kernels whose name holds
    `kernel_key`). The profiler has dropped device events on the card, so a
    profile that holds another count than `want` is taken again, up to
    `tries` times; the caller checks the count of the last."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_events(prof)
        seen = sum(k[1] for k in kernels if kernel_key in k[2])
        if seen == want:
            break
        log(f"profiler saw {seen} of {want} {kernel_key} launches: "
            "profiling again")
    return wall, kernels, seen


def k1_bound_ms(m, c, esize):
    """Least time for one launch: read x and bias once, write out once,
    against 4 float32 operations per element."""
    nbytes = (2 * m * c + c) * esize
    ops = K1_OPS_PER_ELEMENT * m * c
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def randomize_weights(net, seed):
    """Random init leaves every bias at its init value: draw the 1-D
    parameters too, so K1's bias path carries data. Scale the decoder's RGB
    heads by 0.15, so the output image is not mostly clipped at ±1 and the
    uint8 comparisons below see real pixel values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_((0.1 * torch.randn(p.shape, generator=g)).to(p.device))
            if ".to_rgb" in name:
                p.mul_(0.15)


# ------------------------------------------------------------------ phases

def phase_device():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    line = proc.stdout.strip().splitlines()[0].strip()
    log(line)
    log(f"device: {torch.cuda.get_device_name(0)}  count="
        f"{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    return line


def phase_build():
    from image_restoration_tpu_torch.ops import _build
    t0 = time.perf_counter()
    builds = _build.build_all(["fused_bias_act", "int8_conv3x3",
                               "conv3x3_im2col"])
    total = time.perf_counter() - t0
    for b in builds:
        log(f"build {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        fences = sum("C7519" in ln for ln in b.log.splitlines())
        if fences:  # ptxas serialised wgmma it could not keep back to back
            log(f"  ptxas injected {fences} warpgroup.arrive fences")
        for ln in b.log.splitlines():
            if "spill" in ln or ("ptxas info" in ln
                                 and ("Used" in ln or "Compiling" in ln)):
                log(f"  {ln.strip()}")
            require("spill" not in ln
                    or "0 bytes spill stores, 0 bytes spill loads" in ln,
                    f"{b.name} spills registers: {ln.strip()}")
    log(f"build total {total:.2f} s")
    return {b.name: b.seconds for b in builds}


def record_k1_shapes(restorer, u8):
    """The (M, C) of each K1 call of one forward, taken on the plain
    version (no kernel launches)."""
    from image_restoration_tpu_torch.ops import fused_act
    shapes = []
    plain = fused_act.fused_leaky_relu_plain

    def rec(x, bias=None, negative_slope=0.2, scale=fused_act.SQRT2):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, bias, negative_slope, scale)

    with mock.patch.object(fused_act, "fused_leaky_relu", rec):
        restorer.restore_batch_u8(u8)
    return shapes


def phase_kernels(shapes_bs1):
    """K1 against its plain version at every main-path shape; times."""
    from image_restoration_tpu_torch.ops.fused_act import (
        fused_leaky_relu, fused_leaky_relu_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    distinct = sorted(set(shapes_bs1))
    cases = [(m * bs, c, bs) for bs in (1, 16) for m, c in distinct]
    cases += [(12345, 24, None), (771, 3, None)]  # ragged M; scalar path
    rows = []
    worst = 0.0
    log("K1 vs plain, tolerance: f32 max|d| <= 1e-6 * max(1, max|plain|); "
        "bf16 |d| <= 1 ulp of the plain value, element by element")
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for m, c, bs in cases:
            x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
            b = torch.randn((c,), generator=gen, device="cuda")
            got = fused_leaky_relu(x, b)
            want = fused_leaky_relu_plain(x, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                tol = 1e-6 * max(1.0, want.abs().max().item())
                ok = err.max().item() <= tol
            else:  # one bf16 ulp of the plain value
                ok = bool((err <= bf16_ulp(want.float())).all())
            max_err = err.max().item()
            require(ok, f"K1 {dtype} M={m} C={c}: max|d|={max_err}")
            worst = max(worst, max_err)
            nbytes = 2 * m * c * esize
            nbuf = max(1, min(32, math.ceil(256e6 / nbytes)))
            xs = [(x,)] + [(torch.randn((m, c), generator=gen, device="cuda")
                            .to(dtype),) for _ in range(nbuf - 1)]
            iters = max(20, min(200, int(4e9 / nbytes)))
            kern = lambda t: fused_leaky_relu(t, b)  # noqa: E731
            plain = lambda t: fused_leaky_relu_plain(t, b)  # noqa: E731
            row = dict(dtype=str(dtype).replace("torch.", ""), M=m, C=c,
                       batch=bs,
                       per_forward=(shapes_bs1.count((m // bs, c))
                                    if bs else 0),
                       ms=device_time_ms(kern, xs, iters),
                       plain_ms=device_time_ms(plain, xs, iters),
                       call_ms=host_time_ms(kern, xs, iters),
                       plain_call_ms=host_time_ms(plain, xs, iters),
                       bound_ms=k1_bound_ms(m, c, esize), max_abs_err=max_err)
            del xs
            rows.append(row)
            log(f"K1 {row['dtype']:8s} M={m:8d} C={c:4d} bs={bs} "
                f"x{row['per_forward']}/fwd  ms={row['ms']:.5f}  "
                f"plain_ms={row['plain_ms']:.5f}  "
                f"bound_ms={row['bound_ms']:.5f}  "
                f"call_ms={row['call_ms']:.5f}  "
                f"plain_call_ms={row['plain_call_ms']:.5f}  "
                f"max|d|={max_err:.3g}")
    torch.cuda.empty_cache()
    agg = {}
    for dt in ("float32", "bfloat16"):
        for bs in (1, 16):
            sel = [r for r in rows if r["dtype"] == dt and r["batch"] == bs]
            agg[(dt, bs)] = {k: sum(r[k] * r["per_forward"] for r in sel)
                             for k in ("ms", "plain_ms", "bound_ms",
                                       "call_ms", "plain_call_ms")}
            require(sum(r["per_forward"] for r in sel)
                    == K1_LAUNCHES_PER_FORWARD, "shape multiplicities")
            a = agg[(dt, bs)]
            log(f"K1 per forward {dt} bs={bs}: ms={a['ms']:.4f}  "
                f"plain_ms={a['plain_ms']:.4f}  bound_ms={a['bound_ms']:.4f}  "
                f"call_ms={a['call_ms']:.4f}  "
                f"plain_call_ms={a['plain_call_ms']:.4f}")
    return rows, agg, worst


def post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def phase_main_path(restorer, batches, per_forward=K1_LAUNCHES_PER_FORWARD):
    """Counts at 0, then the main path: restores at batch 1/4/16 and four
    HTTP requests. Returns K1's launch count over the whole run."""
    size = restorer.input_size[0]
    import cv2
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server

    fused_leaky_relu.launches = 0
    expected = 0
    for bs, u8 in batches.items():
        before = fused_leaky_relu.launches
        out = restorer.restore_batch_u8(u8)
        torch.cuda.synchronize()
        require(out.dtype == np.uint8 and out.shape == (bs, size, size, 3),
                f"restore bs={bs}: {out.dtype} {out.shape}")
        n = fused_leaky_relu.launches - before
        require(n == per_forward,
                f"bs={bs}: K1 launched {n} times, expected {per_forward}")
        expected += n
        log(f"restore_batch_u8 bs={bs}: uint8 {out.shape}, K1 launches {n}")

    core = ServiceCore(restorer)
    server = make_server(core, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    timings = []
    try:
        requests = [("/Restore/", (120, 360), (size, size, 3)),
                    ("/Restore/", (300, 300), (size, size, 3)),
                    ("/Restore/", (480, 640), (size, size, 3)),
                    ("/RestoreConcat/", (90, 270), (size, 2 * size, 3))]
        bodies = []
        for i, (route, hw, shape) in enumerate(requests):
            ok, buf = cv2.imencode(".jpg", plate_image(*hw, seed=100 + i))
            require(ok, f"JPEG encode of a {hw} image")
            bodies.append(buf)
            before = fused_leaky_relu.launches
            t0 = time.perf_counter()
            status, media, body = post(port, route, buf.tobytes())
            dt = (time.perf_counter() - t0) * 1e3
            img = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and media == "image/jpeg",
                    f"{route}: {status} {media}")
            require(img is not None and img.shape == shape,
                    f"{route}: decoded {None if img is None else img.shape}")
            n = fused_leaky_relu.launches - before
            require(n == per_forward, f"{route}: K1 launched {n} times")
            expected += n
            timings.append(dt)
            log(f"POST {route} {hw[1]}x{hw[0]} jpeg -> 200 {shape}  "
                f"{dt:.2f} ms")
        for (route, hw, _), buf in zip(requests, bodies):
            t0 = time.perf_counter()
            status, _, _ = post(port, route, buf.tobytes())
            t1 = time.perf_counter()
            require(status == 200, f"{route} again: {status}")
            getattr(core, ROUTE_METHODS[route])(
                cv2.imdecode(buf, cv2.IMREAD_COLOR))
            t2 = time.perf_counter()
            log(f"again POST {route} {hw[1]}x{hw[0]}: {(t1 - t0) * 1e3:.2f} "
                f"ms; the same ServiceCore call without HTTP: "
                f"{(t2 - t1) * 1e3:.2f} ms")
            expected += 2 * per_forward
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    launches = fused_leaky_relu.launches
    require(launches == expected, f"K1 count {launches} != {expected}")
    log(f"main path: K1 launches {launches}")
    return launches, timings


def phase_correctness(restorer, u8_4, u8_1):
    """Kernel vs plain K1 in the whole net (TF32 off, ≤1 LSB) and the card
    against the CPU on one image."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.ops import fused_act

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = restorer.restore_batch_u8(u8_4)
        x = torch.from_numpy(u8_4).cuda().float() / 255.0
        x = (x - restorer._mean_t) / restorer._std_t
        got_f = restorer._fwd(x)
        again_f = restorer._fwd(x)
        log("net with K1, run to run (bs=4, TF32 off): float max|d| "
            f"{(got_f - again_f).abs().max().item():.3g}")
        with mock.patch.object(fused_act, "fused_leaky_relu",
                               fused_act.fused_leaky_relu_plain):
            want = restorer.restore_batch_u8(u8_4)
            want_f = restorer._fwd(x)
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        df = (got_f - want_f).abs().max().item()
        log(f"net with K1 vs net with plain K1 (bs=4, TF32 off): "
            f"uint8 max {d.max()} LSB, float max|d| {df:.3g}")
        require(d.max() <= 1, f"K1 net vs plain net: {d.max()} LSB")
        require(bool(torch.isfinite(got_f).all()), "non-finite output")
        y = got_f.float()
        log(f"output stats: mean {y.mean().item():.4f} std "
            f"{y.std().item():.4f} clipped "
            f"{(y.abs() >= 1).float().mean().item():.4f}")
        require(y.std().item() > 1e-3, "constant output")

        cpu = Restorer(PRODUCTION_GFPGAN, device="cpu")
        cpu.net.load_state_dict(restorer.net.state_dict())
        ref = cpu.restore_batch_u8(u8_1)
        gpu = restorer.restore_batch_u8(u8_1)
        dc = np.abs(ref.astype(np.int16) - gpu.astype(np.int16))
        log(f"card vs CPU (bs=1, TF32 off): uint8 max {dc.max()} LSB, "
            f"mean {dc.mean():.5f}, share >1 LSB {(dc > 1).mean():.6f}")
        require(dc.max() <= 4 and dc.mean() <= 0.05,
                f"card vs CPU: max {dc.max()} mean {dc.mean()}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return int(d.max()), float(df), int(dc.max())


def phase_throughput(restorer, batches):
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        "(PyTorch defaults)")
    out = {}
    for bs, u8 in batches.items():
        for _ in range(3):
            restorer.restore_batch_u8(u8)
        torch.cuda.synchronize()
        iters = {1: 40, 4: 30, 16: 20}.get(bs, 20)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            restorer.restore_batch_u8(u8)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[bs] = dict(imgs_per_s=bs / med, ms_per_batch=med * 1e3,
                       ms_min=min(times) * 1e3, ms_max=max(times) * 1e3)
        log(f"restore_batch_u8 bs={bs}: {out[bs]['imgs_per_s']:.2f} imgs/s "
            f"(median {out[bs]['ms_per_batch']:.3f} ms/batch, min "
            f"{out[bs]['ms_min']:.3f}, max {out[bs]['ms_max']:.3f}, "
            f"{iters} calls)")
    torch.cuda.reset_peak_memory_stats()
    restorer.restore_batch_u8(batches[16])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"peak device memory bs=16: {peak:.1f} MiB")
    return out, peak


def phase_profile(restorer, u8):
    """Device time by kernel over one batch-16 restore (torch.profiler)."""
    restorer.restore_batch_u8(u8)
    torch.cuda.synchronize()
    wall_ms, kernels, k1_n = profile_call(
        lambda: restorer.restore_batch_u8(u8), "fused_bias_lrelu",
        K1_LAUNCHES_PER_FORWARD)
    busy = sum(k[0] for k in kernels)
    k1_ms = sum(k[0] for k in kernels if "fused_bias_lrelu" in k[2])
    log(f"profile bs=16: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), K1 {k1_ms:.4f} ms over {k1_n} "
        "launches")
    for t, n, name in kernels[:15]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    require(k1_n == K1_LAUNCHES_PER_FORWARD,
            f"profiler saw {k1_n} K1 launches")
    return dict(wall_ms=wall_ms, busy_ms=busy, k1_device_ms=k1_ms,
                top=[dict(ms=t, count=n, name=name[:200])
                     for t, n, name in kernels[:25]])


# ----------------------------------------------------- path 2: SR engine

def k2_bound_ms(n, h, w, cin, cout):
    """Least time for one SAME-padded launch: 2·MACs (the block-diagonal
    zeros included, as the kernel computes them) over the int8 tensor-core
    peak, or x, weights and out once over the memory rate, the larger."""
    ops = 2 * n * h * w * cout * 9 * cin
    nbytes = n * h * w * (cin + cout) + cout * 9 * cin + 3 * cout * 2
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3, (
        "operations" if ops / INT8_OPS_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes")


def k2_layer_shapes():
    """(name, Cin, Cout, launches per engine call, PReLU) of the chain."""
    f, oc = SR["num_feat"] * 2, 3 * SR["upscale"] ** 2 * 2
    return [("body_0", 6, f, 1, True),
            (f"body_1..{SR['num_conv']}", f, f, SR["num_conv"], True),
            ("conv_last", f, oc, 1, False)]


def k2_inputs(gen, n, h, w, cin, cout, epilogue, prelu):
    """Random int8 x and weights, and epilogue vectors that spread |acc·deq|
    to about 100, so rounding and the ±127 clip both matter."""
    from image_restoration_tpu_torch.ops.int8_conv import EPILOGUES
    pdt = EPILOGUES[epilogue][1]
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                      device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, 3, 3, cin), generator=gen,
                       device="cuda", dtype=torch.int8)
    scale = 100.0 / (math.sqrt(9 * cin) * 127 ** 2 / 3)
    deq = (torch.rand(cout, generator=gen, device="cuda") * scale).to(pdt)
    b = (torch.randn(cout, generator=gen, device="cuda") * 5).to(pdt)
    a = torch.rand(cout, generator=gen, device="cuda").to(pdt)
    return x, wt, deq, b, (a if prelu else None)


def saturate(x, wt):
    """Sums of 2^22 and more in one corner (Cin >= 32, H and W > 8): the
    kernel's threads holding them take its scalar epilogue."""
    if x.shape[1] > 8 and x.shape[2] > 8 and x.shape[3] >= 32:
        x[:, :5, :6] = 127
        wt[:min(wt.shape[0], 9)] = 127


def im2col(x, cin_to):
    """(N, H, W, C) int8 → (N·H·W, 9·cin_to), taps major, channels minor:
    the A of the SAME conv as one matrix product (the weights' (Cout, 3, 3,
    Cin) reshaped is B)."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, cin_to - c, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(n * h * w,
                                                           9 * cin_to)


def phase_k2_kernels():
    """K2 against its plain version at each layer shape of an engine call,
    both epilogues (integer-exact), with times and yardsticks; then ragged
    shapes, exactness only."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = SR["batch"] // 2
    s = SR["tile"] + 2 * SR["halo"]
    rows = []
    log("K2 vs plain, tolerance: integer-exact (max|d| == 0); times are "
        "device ms per launch at the engine's shapes (N=4 packed images of "
        f"{s}²)")
    for name, cin, cout, per_call, prelu in k2_layer_shapes():
        bound, bound_by = k2_bound_ms(n, s, s, cin, cout)
        for epilogue in ("bf16", "f32"):
            x, wt, deq, b, a = k2_inputs(gen, n, s, s, cin, cout, epilogue,
                                         prelu)
            got = int8_conv3x3_requant(x, wt, deq, b, a, 64.0,
                                       epilogue=epilogue)
            want = int8_conv3x3_requant_plain(x, wt, deq, b, a, 64.0,
                                              epilogue=epilogue)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            clipped = (got.abs() == 127).float().mean().item()
            require(err == 0, f"K2 {name} {epilogue}: max|d| {err}")
            del got, want
            row = dict(layer=name, epilogue=epilogue, N=n, H=s, W=s,
                       Cin=cin, Cout=cout, per_call=per_call,
                       max_abs_err=err, share_clipped=clipped,
                       bound_ms=bound, bound_by=bound_by)
            row["ms"] = device_time_ms(
                lambda t: int8_conv3x3_requant(t, wt, deq, b, a, 64.0,
                                               epilogue=epilogue),
                [(x,)], 20)
            row["plain_ms"] = device_time_ms(
                lambda t: int8_conv3x3_requant_plain(t, wt, deq, b, a, 64.0,
                                                     epilogue=epilogue),
                [(x,)], 3)
            if epilogue == "bf16":
                cpad = -(-cin // 8) * 8
                a_mat = im2col(x, cpad)
                b_mat = F.pad(wt, (0, cpad - cin)).reshape(cout, 9 * cpad).t()
                acc = torch._int_mm(a_mat, b_mat)
                ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                               wt.permute(0, 3, 1, 2).double(), padding=1)
                require(torch.equal(acc.double(), ref.permute(0, 2, 3, 1)
                                    .reshape(-1, cout)),
                        f"_int_mm yardstick differs from the conv ({name})")
                del acc, ref
                row["int_mm_ms"] = device_time_ms(
                    lambda t: torch._int_mm(t, b_mat), [(a_mat,)], 20)
                del a_mat
                xb = x.permute(0, 3, 1, 2).bfloat16()  # channels_last memory
                wb = wt.permute(0, 3, 1, 2).bfloat16().contiguous(
                    memory_format=torch.channels_last)
                row["cudnn_bf16_ms"] = device_time_ms(
                    lambda t: F.conv2d(t, wb, padding=1), [(xb,)], 20)
                del xb, wb
            rows.append(row)
            log(f"K2 {name:10s} {epilogue:4s} {cin:3d}->{cout:3d} "
                f"x{per_call}/call  ms={row['ms']:.4f}  "
                f"plain_ms={row['plain_ms']:.4f}  bound_ms={bound:.4f} "
                f"({bound_by})  int_mm_ms={row.get('int_mm_ms', 0):.4f}  "
                f"cudnn_bf16_ms={row.get('cudnn_bf16_ms', 0):.4f}  "
                f"clipped={clipped:.4f}  max|d|={err}")
            del x
            torch.cuda.empty_cache()
    for n_, h, w, cin, cout, pad in [(3, 37, 45, 10, 24, 1),
                                     (3, 37, 45, 10, 24, 0),
                                     (1, 5, 3, 6, 128, 1),
                                     (2, 25, 528, 6, 96, 1),
                                     (1, 1, 40, 64, 192, 1),
                                     (3, 64, 136, 32, 160, 1),
                                     (1, 9, 30, 128, 192, 1)]:
        for epilogue in ("bf16", "f32"):
            for prelu in (True, False):
                x, wt, deq, b, a = k2_inputs(gen, n_, h, w, cin, cout,
                                             epilogue, prelu)
                saturate(x, wt)
                got = int8_conv3x3_requant(x, wt, deq, b, a, 64.0, pad=pad,
                                           epilogue=epilogue)
                want = int8_conv3x3_requant_plain(x, wt, deq, b, a, 64.0,
                                                  pad=pad, epilogue=epilogue)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"K2 ragged {(n_, h, w, cin, cout, pad)} {epilogue} "
                        f"prelu={prelu}")
    log("K2 ragged shapes (odd H and W, 528 wide, H 1, 176 and 144 tiles, "
        "Cin 6/10/32/64/128, Cout 24/96/128/160/192, sums >= 2^22 in a "
        "corner, pad 0 and 1, with and without PReLU, both epilogues): "
        "integer-exact")
    per_call = {k: sum(r[k] * r["per_call"] for r in rows
                       if r["epilogue"] == "bf16")
                for k in ("ms", "plain_ms", "bound_ms", "int_mm_ms",
                          "cudnn_bf16_ms")}
    log(f"K2 per engine call ({K2_LAUNCHES_PER_CALL} launches, bf16 "
        "epilogue): "
        + "  ".join(f"{k}={v:.4f}" for k, v in per_call.items()))
    return rows, per_call


def sr_calib():
    """Two 128² float crops of a seeded synthetic scene (the exporter's
    calibration batch size)."""
    img = scene_image(384, 512, seed=7).astype(np.float32) / 255.0
    return np.stack([img[40:168, 60:188], img[200:328, 300:428]])


def build_sr(int8=True):
    from image_restoration_tpu_torch.serve.engine_restorer import (
        EngineRestorer)
    return EngineRestorer.build(int8=int8, calib=sr_calib(), seed=0,
                                device="cuda", **SR)


def phase_sr_main_path(restorer, engine):
    """Counts at 0, then the SR path: EngineRestorer on a 1024×768 image and
    one POST to /SRx4/. Returns K2's launch count over the run."""
    import cv2
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server

    def chunks(h, w):
        tiles = math.ceil(h / SR["tile"]) * math.ceil(w / SR["tile"])
        return math.ceil(tiles / SR["batch"])

    fused_leaky_relu.launches = 0
    int8_conv3x3_requant.launches = 0
    img = scene_image(768, 1024, seed=21)
    t0 = time.perf_counter()
    out = engine(img)
    dt = (time.perf_counter() - t0) * 1e3
    n = int8_conv3x3_requant.launches
    require(out.dtype == np.uint8 and out.shape == (3072, 4096, 3),
            f"EngineRestorer: {out.dtype} {out.shape}")
    require(n == K2_LAUNCHES_PER_CALL * chunks(768, 1024),
            f"EngineRestorer: K2 launched {n} times")
    log(f"EngineRestorer 1024x768 -> {out.shape[1]}x{out.shape[0]} uint8 in "
        f"{dt:.1f} ms (first call), {chunks(768, 1024)} engine chunk(s), "
        f"K2 launches {n}")
    expected = n
    core = ServiceCore(restorer, engine)
    server = make_server(core, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    req_ms = []
    try:
        bgr = np.ascontiguousarray(scene_image(360, 640, seed=22)[..., ::-1])
        ok, buf = cv2.imencode(".png", bgr)
        require(ok, "PNG encode")
        for i in range(2):
            before = int8_conv3x3_requant.launches
            t0 = time.perf_counter()
            status, media, body = post(port, "/SRx4/", buf.tobytes())
            req_ms.append((time.perf_counter() - t0) * 1e3)
            got = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and media == "image/png",
                    f"/SRx4/: {status} {media}")
            require(got is not None and got.shape == (1440, 2560, 3),
                    f"/SRx4/: decoded {None if got is None else got.shape}")
            n = int8_conv3x3_requant.launches - before
            require(n == K2_LAUNCHES_PER_CALL * chunks(360, 640),
                    f"/SRx4/: K2 launched {n} times")
            expected += n
            log(f"POST /SRx4/ 640x360 png -> 200 image/png 2560x1440  "
                f"{req_ms[-1]:.1f} ms, K2 launches {n}")
        t0 = time.perf_counter()
        direct = engine(np.ascontiguousarray(bgr[..., ::-1]))[..., ::-1]
        t1 = time.perf_counter()
        ok, _ = cv2.imencode(".png", np.ascontiguousarray(direct))
        t2 = time.perf_counter()
        expected += K2_LAUNCHES_PER_CALL * chunks(360, 640)
        require(np.array_equal(got, direct),
                "/SRx4/ answer differs from the engine's own output")
        log(f"/SRx4/ 640x360 split: EngineRestorer {(t1 - t0) * 1e3:.1f} ms, "
            f"PNG encode of the 2560x1440 answer {(t2 - t1) * 1e3:.1f} ms")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    launches = int8_conv3x3_requant.launches
    require(launches == expected, f"K2 count {launches} != {expected}")
    require(fused_leaky_relu.launches == 0,
            f"K1 launched {fused_leaky_relu.launches} times on the SR path")
    log(f"SR main path: K2 launches {launches} "
        f"({K2_LAUNCHES_PER_CALL} per engine chunk), K1 launches 0")
    return launches, req_ms


def span_psnr(ref, got):
    ref, got = ref.float(), got.float()
    mse = ((ref - got) ** 2).mean().item()
    span = (ref.max() - ref.min()).item() or 1.0
    return 10 * math.log10(span ** 2 / max(mse, 1e-12))


def phase_sr_correctness():
    """TF32 off: chain on K2 vs chain on plain K2 (every layer), int8 vs
    packed bf16 (≥30 dB), tiled vs untiled float net, card vs CPU."""
    from unittest import mock as _mock
    from image_restoration_tpu_torch.infer import SR_MEAN_STD, SRVGG_X4
    from image_restoration_tpu_torch.infer import Restorer
    from image_restoration_tpu_torch.ops import int8_conv
    from image_restoration_tpu_torch.ops import quantized_inference as qi
    from image_restoration_tpu_torch.ops.packed_inference import (
        pack_srvgg_params, packed_srvgg_forward)
    from image_restoration_tpu_torch.parallel.tiling import tiled_apply
    from image_restoration_tpu_torch.serve.sr_engine import build_srvgg

    nc, up = SR["num_conv"], SR["upscale"]
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = build_srvgg(SR["num_feat"], nc, up, seed=0, device="cuda")
        calib = torch.from_numpy(sr_calib()).cuda()
        scales = qi.calibrate_srvgg_act_scales(net, calib)
        net_cpu = build_srvgg(SR["num_feat"], nc, up, seed=0, device="cpu")
        cs = qi.calibrate_srvgg_act_scales(net_cpu, calib[:1, :64, :64].cpu())
        gs = qi.calibrate_srvgg_act_scales(net, calib[:1, :64, :64])
        rel = ((gs.cpu() - cs).abs() / cs).max().item()
        # tolerance: f32 convs sum in another order on each device, over
        # 34 layers
        log(f"calibration maxima, card vs CPU on one 64² crop (TF32 off): "
            f"max rel |d| {rel:.3g} (tolerance 1e-4)")
        require(rel <= 1e-4, f"calibration card vs CPU: {rel}")
        q = qi.quantize_srvgg_params(net, scales.tolist(), pack=2)
        log("calibration scales: " + " ".join(f"{v:.4g}" for v in
                                               scales.tolist()))

        s = SR["tile"] + 2 * SR["halo"]
        big = scene_image(2 * s, 4 * s, seed=23)
        tiles = np.stack([big[i * s:(i + 1) * s, j * s:(j + 1) * s]
                          for i in range(2) for j in range(4)])
        x = (torch.from_numpy(tiles).cuda().to(torch.bfloat16) / 255.0)

        acts = []
        real = int8_conv.int8_conv3x3_requant

        def record(*a, **k):
            out = real(*a, **k)
            acts.append(out)
            return out

        with _mock.patch.object(qi, "int8_conv3x3_requant", record):
            got = qi.quantized_srvgg_forward(q, x, nc, up, pack=2)
        torch.cuda.synchronize()
        require(len(acts) == K2_LAUNCHES_PER_CALL, f"{len(acts)} K2 calls")
        layer = iter(range(len(acts)))
        worst = 0

        def compare(*a, **k):
            out = int8_conv.int8_conv3x3_requant_plain(*a, **k)
            i = next(layer)
            d = (out.int() - acts[i].int()).abs().max().item()
            nonlocal worst
            worst = max(worst, d)
            require(d == 0, f"chain layer {i}: K2 vs plain max|d| {d}")
            acts[i] = None
            return out

        with _mock.patch.object(qi, "int8_conv3x3_requant", compare):
            want = qi.quantized_srvgg_forward(q, x, nc, up, pack=2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "chain output: K2 vs plain differ")
        log(f"int8 chain on K2 vs on plain K2 (8 tiles of {s}², TF32 off): "
            f"{len(acts)} int8 activations equal (max|d| {worst}), bf16 "
            "output bit-equal")
        res["chain_k2_vs_plain_max_abs"] = worst
        del acts

        packed = pack_srvgg_params(net)
        ref = packed_srvgg_forward(packed, x, nc, up)
        db = span_psnr(ref, got)
        log(f"int8 vs packed bf16 at {s}² (8 synthetic-scene tiles): "
            f"span-normalized PSNR {db:.2f} dB (gate >= {SR_GATE_DB})")
        require(db >= SR_GATE_DB, f"int8 vs bf16 {db:.2f} dB")
        res["int8_vs_bf16_db"] = db
        del ref, packed

        sr = Restorer(SRVGG_X4, device="cuda", seed=0, **SR_MEAN_STD)
        img = torch.from_numpy(scene_image(300, 400, seed=24)).cuda()
        xf = img[None].float() / 255.0
        untiled = sr._fwd(xf)[0]
        halo = RECEPTIVE_RADIUS + 6
        tiled = tiled_apply(sr._fwd, xf, tile=128, halo=halo, scale=up,
                            tile_batch=4)[0]
        b = RECEPTIVE_RADIUS * up
        d = (tiled[b:-b, b:-b] - untiled[b:-b, b:-b]).abs().max().item()
        span = (untiled.max() - untiled.min()).item()
        # tolerance: cuDNN may pick another f32 algorithm (summation order)
        # for the tile shape than for the whole image
        log(f"float net tiled (tile 128, halo {halo}) vs untiled, 400x300, "
            f"interior ({b} px from the border): max|d| {d:.3g} over a span "
            f"of {span:.3g} (tolerance 1e-4 of the span)")
        require(d <= 1e-4 * max(1.0, span), f"tiled vs untiled: {d}")
        res["tiled_vs_untiled_max_abs"] = d
        del sr, untiled, tiled

        pair = x[:2, :64, :64].contiguous()
        q_cpu = {k: v.cpu() for k, v in q.items()}
        cpu = qi.quantized_srvgg_forward(q_cpu, pair.cpu(), nc, up, pack=2)
        card = qi.quantized_srvgg_forward(q, pair, nc, up, pack=2)
        dc = (card.cpu().float() - cpu.float()).abs().max().item()
        log(f"int8 chain, card vs CPU (two 64² tiles, full width and depth): "
            f"max|d| {dc}")
        require(dc == 0, f"card vs CPU: {dc}")
        res["card_vs_cpu_max_abs"] = dc
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.empty_cache()
    return res


def median_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def phase_sr_throughput(engine_int8, engine_bf16):
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "(PyTorch default)")
    s = SR["tile"] + 2 * SR["halo"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(0, 256, (SR["batch"], s, s, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    img = scene_image(768, 1024, seed=21)
    out = {}
    for mode, eng in (("int8", engine_int8), ("bf16", engine_bf16)):
        med, lo, hi = median_ms(lambda: eng.serve(x), 10)
        e2e, e_lo, e_hi = median_ms(lambda: eng(img), 3)
        out[mode] = dict(ms_per_call=med, ms_min=lo, ms_max=hi,
                         tiles_per_s=SR["batch"] / med * 1e3,
                         image_1024x768_ms=e2e)
        log(f"SR engine {mode}: {med:.3f} ms per call of {SR['batch']} "
            f"tiles (min {lo:.3f}, max {hi:.3f}) = "
            f"{out[mode]['tiles_per_s']:.2f} tiles/s (512² in, 2048² out); "
            f"EngineRestorer 1024x768: {e2e:.2f} ms (min {e_lo:.2f})")
    torch.cuda.reset_peak_memory_stats()
    engine_int8.serve(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"peak device memory, one int8 engine call: {peak:.1f} MiB")

    out["peak_mib"] = peak
    for mode, eng in (("int8", engine_int8), ("bf16", engine_bf16)):
        want = K2_LAUNCHES_PER_CALL if mode == "int8" else 0
        wall, kernels, k2_n = profile_call(lambda: eng.serve(x),
                                           "int8_conv3x3", want)
        busy = sum(k[0] for k in kernels)
        k2_ms = sum(k[0] for k in kernels if "int8_conv3x3" in k[2])
        log(f"profile of one {mode} engine call: wall {wall:.3f} ms, device "
            f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%), K2 {k2_ms:.3f} "
            f"ms over {k2_n} launches")
        for t, n, name in kernels[:12]:
            log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
        require(k2_n == want, f"profiler saw {k2_n} K2 launches ({mode})")
        out[f"profile_{mode}"] = dict(
            wall_ms=wall, busy_ms=busy, k2_device_ms=k2_ms,
            top=[dict(ms=t, count=n, name=name[:200])
                 for t, n, name in kernels[:20]])
    return out


# ------------------------------------------------------ path 3: ESRGAN ×4

RRDB_SIZE = 528             # the served tile, 512 + 2·8 halo (bench_rrdb.py)
RRDB_GATE_DB = 30.0         # int8 vs the float32 forward, at 2 blocks
RRDB_STAGES = [(64, 192), (32, 160), (32, 128), (32, 96), (32, 64)]
K2_STAGE_LAUNCHES = 15      # per RRDB block: 3 dense blocks × 5 stages


def k3_bound_ms(n, h, w, cin, cout):
    """Least time for one launch, bf16 in and out: x (pre-padded), the
    weights and out once over the memory rate, or 2·MACs over the bf16
    tensor-core peak, the larger."""
    ops = 2 * n * h * w * cout * 9 * cin
    nbytes = 2 * (n * (h + 2) * (w + 2) * cin + 9 * cin * cout
                  + n * h * w * cout)
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_k3_kernels():
    """K3 against its plain version at the probe's five stage shapes at
    528² and a ragged shape; device times, bound, cuDNN; then the probe."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.im2col_conv import (
        conv3x3_im2col, conv3x3_im2col_plain)
    from image_restoration_tpu_torch.scripts import probe_conv
    gen = torch.Generator(device="cuda").manual_seed(3)
    s = RRDB_SIZE
    log("K3 vs plain, tolerance: float32 out max|d| <= 1e-5 * max|plain|; "
        "bf16 out |d| <= 1 bf16 ulp of the plain value + 1e-5 * max|plain| "
        "(sums that cancel to near zero)")
    rows, worst = [], 0.0
    cases = [(1, s, s, cin, cout, 4 if cin == 64 else 8)
             for cin, cout in RRDB_STAGES] + [(2, 37, 45, 24, 36, 1)]
    for n, h, w, cin, cout, bh in cases:
        x = torch.randn((n, h + 2, w + 2, cin), generator=gen,
                        device="cuda").bfloat16()
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              * 0.05).bfloat16()
        for out_dtype in (torch.float32, torch.bfloat16):
            got = conv3x3_im2col(x, wt, bh=bh, out_dtype=out_dtype)
            want = conv3x3_im2col_plain(x, wt, bh=bh, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            tol = 1e-5 * want.abs().max().item()
            if out_dtype == torch.float32:
                ok = err.max().item() <= tol
            else:
                ok = bool((err <= bf16_ulp(want.float()) + tol).all())
                worst = max(worst, err.max().item())
            require(ok, f"K3 {(n, h, w, cin, cout)} {out_dtype}: max|d| "
                        f"{err.max().item()}")
            del got, want, err
        if h != s:
            continue
        bound, bound_by = k3_bound_ms(n, h, w, cin, cout)
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row = dict(Cin=cin, Cout=cout, N=n, H=h, W=w, bound_ms=bound,
                   bound_by=bound_by,
                   ms=device_time_ms(
                       lambda t: conv3x3_im2col(t, wt, bh=bh), [(x,)], 40),
                   plain_ms=device_time_ms(
                       lambda t: conv3x3_im2col_plain(t, wt, bh=bh),
                       [(x,)], 5),
                   cudnn_bf16_ms=device_time_ms(
                       lambda t: F.conv2d(t, wc), [(xc,)], 40))
        rows.append(row)
        log(f"K3 {cin:3d}->{cout:3d} {s}²  ms={row['ms']:.5f}  "
            f"plain_ms={row['plain_ms']:.5f}  bound_ms={bound:.5f} "
            f"({bound_by}, {100 * bound / row['ms']:.1f}% of it)  "
            f"cudnn_bf16_ms={row['cudnn_bf16_ms']:.5f}  "
            f"TFLOP/s={2 * 9 * cin * cout * s * s / row['ms'] / 1e9:.1f}")
        del x, xc
    log("K3 ragged shape (2 images, 37x45, Cin 24 padded to 32, Cout 36, "
        "bh 1), both out dtypes: within tolerance")
    per_pass = {k: sum(r[k] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms")}
    log("K3 per pass over the five stages: "
        + "  ".join(f"{k}={v:.5f}" for k, v in per_pass.items())
        + f"  ({100 * per_pass['bound_ms'] / per_pass['ms']:.1f}% of the "
          "bound)")
    # a launch's fixed cost: 48 rows of 528 are 132 tiles of 8 x 24, one per
    # block (two at 64 -> 192, whose 132 blocks split into two slices)
    for row, (cin, cout) in zip(rows, RRDB_STAGES):
        x = torch.randn((1, 50, s + 2, cin), generator=gen,
                        device="cuda").bfloat16()
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              * 0.05).bfloat16()
        row["ms_48x528"] = device_time_ms(
            lambda t: conv3x3_im2col(t, wt), [(x,)], 40)
    log("K3 at 48x528 (132 tiles), ms per stage: "
        + "  ".join(f"{r['ms_48x528']:.5f}" for r in rows))
    torch.cuda.empty_cache()

    conv3x3_im2col.launches = 0
    probe = probe_conv.main([])
    k3_launches = conv3x3_im2col.launches
    require(k3_launches > 0, "probe_conv.main launched K3 no time")
    log(f"probe_conv.main: K3 launches {k3_launches}")
    return rows, per_pass, worst, probe, k3_launches


def phase_k2_deq():
    """K2's bf16_deq epilogue against its plain version at the five RRDB
    stage shapes at 528² (SAME padding), for one image and for the ladder's
    batch of 4, and at ragged shapes: bit-equal; times for one image, with
    torch._int_mm on the im2col matrix as the yardstick."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    gen = torch.Generator(device="cuda").manual_seed(4)
    s = RRDB_SIZE
    rows = []
    for st, (cin, cout) in enumerate(RRDB_STAGES):
        for n in (4, 1):  # the 1-image inputs stay for the timing below
            x, wt, deq, b, _ = k2_inputs(gen, n, s, s, cin, cout, "bf16_deq",
                                         False)
            bias = b if st == 0 else None  # only stage 0 adds the biases
            got = int8_conv3x3_requant(x, wt, deq, bias, epilogue="bf16_deq")
            want = int8_conv3x3_requant_plain(x, wt, deq, bias,
                                              epilogue="bf16_deq")
            torch.cuda.synchronize()
            require(got.dtype == torch.bfloat16 and torch.equal(got, want),
                    f"K2 bf16_deq N={n} {cin}->{cout}: max|d| "
                    f"{(got.float() - want.float()).abs().max().item()}")
            del got, want
        ops = 2 * s * s * cout * 9 * cin
        nbytes = s * s * (cin + 2 * cout) + cout * 9 * cin
        t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        row = dict(Cin=cin, Cout=cout, bias=bias is not None,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ms=device_time_ms(lambda t: int8_conv3x3_requant(
                       t, wt, deq, bias, epilogue="bf16_deq"), [(x,)], 20),
                   plain_ms=device_time_ms(
                       lambda t: int8_conv3x3_requant_plain(
                           t, wt, deq, bias, epilogue="bf16_deq"),
                       [(x,)], 3))
        # the yardstick: the contraction alone as one int8 matrix product
        a_mat = im2col(x, cin)
        b_mat = wt.reshape(cout, 9 * cin).t()
        acc = torch._int_mm(a_mat, b_mat)
        ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                       wt.permute(0, 3, 1, 2).double(), padding=1)
        require(torch.equal(acc.double(), ref.permute(0, 2, 3, 1)
                            .reshape(-1, cout)),
                f"_int_mm yardstick differs from the conv ({cin}->{cout})")
        del acc, ref
        row["int_mm_ms"] = device_time_ms(
            lambda t: torch._int_mm(t, b_mat), [(a_mat,)], 20)
        del a_mat
        rows.append(row)
        log(f"K2 bf16_deq {cin:3d}->{cout:3d} {s}²  ms={row['ms']:.4f}  "
            f"plain_ms={row['plain_ms']:.4f}  bound_ms={row['bound_ms']:.5f}"
            f" ({row['bound_by']})  int_mm_ms={row['int_mm_ms']:.4f}  "
            "bit-equal at N=1 and N=4")
        del x
    for n, h, w, cin, cout in [(2, 25, 528, 32, 160), (1, 1, 528, 64, 192),
                               (3, 64, 136, 32, 128), (1, 9, 30, 128, 192),
                               (2, 19, 37, 10, 36)]:
        x, wt, deq, b, _ = k2_inputs(gen, n, h, w, cin, cout, "bf16_deq",
                                     False)
        saturate(x, wt)
        for bias in (b, None):
            got = int8_conv3x3_requant(x, wt, deq, bias, epilogue="bf16_deq")
            want = int8_conv3x3_requant_plain(x, wt, deq, bias,
                                              epilogue="bf16_deq")
            torch.cuda.synchronize()
            require(torch.equal(got.view(torch.int16),
                                want.view(torch.int16)),
                    f"K2 bf16_deq ragged {(n, h, w, cin, cout)} "
                    f"bias={bias is not None}")
    log("K2 bf16_deq ragged shapes (528 wide with H 25 and 1, W 136 and 37, "
        "Cin 10/32/64/128, Cout 36/128/160/192, sums >= 2^22 in a corner, "
        "with and without bias): bit-equal, signed zeros included")
    per_fwd = {k: 3 * 23 * sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "int_mm_ms")}
    log("K2 bf16_deq per RRDBNet-23 forward of one 528² tile (345 launches): "
        + "  ".join(f"{k}={v:.3f}" for k, v in per_fwd.items()))
    torch.cuda.empty_cache()
    return rows, per_fwd


def _counts_zero():
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.ops.im2col_conv import conv3x3_im2col
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    kernels = (fused_leaky_relu, int8_conv3x3_requant, conv3x3_im2col)
    for k in kernels:
        k.launches = 0
    return kernels


def phase_rrdb_main_path():
    """Counts at 0; `infer --arch rrdbnet --tile 512` on a 1024×768 PNG and
    `restore_tiled_u8` on the same image (cuDNN convs: no kernel of the
    port launches); then card vs CPU at full width and depth."""
    import tempfile
    import cv2
    from image_restoration_tpu_torch import infer
    img = scene_image(768, 1024, seed=31)
    kernels = _counts_zero()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "street.png")
        cv2.imwrite(src, img[..., ::-1])
        t0 = time.perf_counter()
        infer.main(["--input", src, "--output", os.path.join(tmp, "out"),
                    "--arch", "rrdbnet", "--tile", "512"])
        cli_s = time.perf_counter() - t0
        out = cv2.imread(os.path.join(tmp, "out", "street_restored.png"))
    require(out is not None and out.shape == (3072, 4096, 3),
            f"--arch rrdbnet wrote {None if out is None else out.shape}")
    require(float(out.std()) > 1.0, "constant --arch rrdbnet output")
    log(f"infer --arch rrdbnet --tile 512, 1024x768 PNG -> 4096x3072 PNG in "
        f"{cli_s:.2f} s (first call: weights, cuDNN plans, PNG IO)")
    restorer = infer.Restorer(infer.RRDBNET_X4, device="cuda", seed=0,
                              **infer.SR_MEAN_STD)
    first = restorer.restore_tiled_u8(img, tile=512)
    med, lo, hi = median_ms(lambda: restorer.restore_tiled_u8(img, tile=512),
                            3)
    require(first.shape == (3072, 4096, 3) and first.dtype == np.uint8,
            f"restore_tiled_u8: {first.shape}")
    launches = [k.launches for k in kernels]
    log(f"Restorer(RRDBNET_X4).restore_tiled_u8 1024x768 (4 tiles of 544², "
        f"float32, TF32 on): median {med:.1f} ms (min {lo:.1f}, max "
        f"{hi:.1f}); launches K1/K2/K3 on this path: {launches}")

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        small = img[300:348, 400:464][None].copy()
        cpu = infer.Restorer(infer.RRDBNET_X4, device="cpu", seed=0,
                             **infer.SR_MEAN_STD)
        t0 = time.perf_counter()
        ref = cpu.restore_batch_u8(small)
        cpu_s = time.perf_counter() - t0
        gpu = restorer.restore_batch_u8(small)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    dc = np.abs(ref.astype(np.int16) - gpu.astype(np.int16))
    log(f"RRDBNet-23 card vs CPU, 64x48 -> 256x192 (TF32 off): uint8 max "
        f"{dc.max()} LSB, mean {dc.mean():.5f} (CPU {cpu_s:.1f} s)")
    require(dc.max() <= 1, f"RRDBNet card vs CPU: {dc.max()} LSB")
    del restorer
    torch.cuda.empty_cache()
    return dict(cli_s=cli_s, restore_tiled_u8_ms=med, card_vs_cpu_lsb=int(
        dc.max()), launches=launches)


def rrdb_calib(size=160):
    """Two crops of a seeded synthetic scene (bench_rrdb.py calibrates on
    two 160² tiles)."""
    img = scene_image(384, 512, seed=33).astype(np.float32) / 255.0
    return np.stack([img[20:20 + size, 40:40 + size],
                     img[200:200 + size, 300:300 + size]])


def phase_rrdb_ladder():
    """bench_rrdb.py's ladder at 528², RRDBNet-23: tiles/s, peak memory,
    and a profile of one int8 forward."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.infer import RRDBNET_X4
    from image_restoration_tpu_torch.ops import packed_inference as pk
    from image_restoration_tpu_torch.ops import rrdb_quant as rq
    from image_restoration_tpu_torch.ops import rrdb_widened as wd
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    s, nb = RRDB_SIZE, RRDBNET_X4["num_block"]
    net = build_network(dict(RRDBNET_X4, dtype="bf16"),
                        torch.Generator().manual_seed(0)).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(6)
    xs = {bs: torch.rand((bs, s, s, 3), generator=gen, device="cuda")
          for bs in (1, 2, 4)}
    q = rq.quantize_rrdb_params(net, rq.calibrate_rrdb_act_scales(
        net, torch.from_numpy(rrdb_calib()).cuda()))
    ladder = [
        ("plain-bf16", 1, net, None),
        ("packed-g4-bf16", 4, pk.pack_rrdbnet_params(net, g=4),
         lambda p, x: pk.packed_rrdbnet_forward(p, x, nb, 4, g=4)),
        ("widened-bf16", 1, wd.widen_rrdbnet_params(net, g=1),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb)),
        ("widened-bf16", 4, None, None),
        ("widened-g2-bf16", 2, wd.widen_rrdbnet_params(net, g=2),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb, g=2)),
        ("widened-g4-bf16", 4, wd.widen_rrdbnet_params(net, g=4),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb, g=4)),
        ("widened-int8", 1, q, lambda p, x: rq.quantized_rrdb_forward(
            p, x, nb)),
        ("widened-int8", 4, None, None),
    ]
    rows, prev = [], None
    log(f"RRDBNet-23 x4 ladder at {s}² (random input; cudnn TF32 setting "
        "irrelevant: bf16 and int8)")
    for name, bs, params, fn in ladder:
        if params is None:
            params, fn = prev
        prev = (params, fn)
        x = xs[bs]

        @torch.inference_mode()
        def call():
            return net(x) if fn is None else fn(params, x)

        is_int8 = name.endswith("int8")
        if is_int8:
            int8_conv3x3_requant.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        require(out.shape == (bs, 4 * s, 4 * s, 3)
                and bool(torch.isfinite(out.float()).all()),
                f"{name} bs={bs}: {tuple(out.shape)}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        del out
        runs = 2 if is_int8 else 3  # 3 and 5 before path 15
        med, lo, hi = median_ms(call, runs)
        row = dict(mode=name, bs=bs, ms=med, ms_min=lo, ms_max=hi,
                   tiles_per_s=bs / med * 1e3, peak_mib=peak)
        if is_int8:
            calls = 1 + 2 + runs  # checked call, median_ms's warm-up, runs
            row["k2_launches"] = int8_conv3x3_requant.launches
            require(row["k2_launches"] == calls * K2_STAGE_LAUNCHES * nb,
                    f"{name} bs={bs}: K2 launched {row['k2_launches']} "
                    f"times in {calls} forwards")
        rows.append(row)
        log(f"RRDB-23 {name} bs={bs}: {med:.2f} ms (min {lo:.2f}, max "
            f"{hi:.2f}) -> {row['tiles_per_s']:.3f} tiles/s, peak "
            f"{peak:.1f} MiB" + (f", K2 launches {row['k2_launches']}"
                                 if is_int8 else ""))
    x = xs[1]
    rq.quantized_rrdb_forward(q, x, nb)
    torch.cuda.synchronize()
    wall, kernels, k2_n = profile_call(
        lambda: rq.quantized_rrdb_forward(q, x, nb), "int8_conv3x3",
        K2_STAGE_LAUNCHES * nb)
    busy = sum(k[0] for k in kernels)
    k2_ms = sum(k[0] for k in kernels if "int8_conv3x3" in k[2])
    log(f"profile of one int8 RRDB-23 forward (bs 1, {s}²): wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), K2 {k2_ms:.2f} ms over {k2_n} "
        f"launches ({100 * k2_ms / max(busy, 1e-9):.1f}% of device time)")
    for t, n, name in kernels[:10]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    require(k2_n == K2_STAGE_LAUNCHES * nb, f"profiler saw {k2_n} K2 "
            "launches in one int8 forward")
    prof_row = dict(wall_ms=wall, busy_ms=busy, k2_device_ms=k2_ms,
                    k2_launches=k2_n, top=[dict(ms=t, count=n, name=name[:200])
                                           for t, n, name in kernels[:15]])
    del xs, ladder, prev
    torch.cuda.empty_cache()
    return rows, prof_row, net, q


def phase_rrdb_int8_check(net23, q23):
    """TF32 off. At 2 blocks: the chain on K2 against the chain on K2's
    plain version at 528² (stage inputs and outputs equal), and int8 against
    the float32 forward at 256² (≥30 dB). The 23-block PSNR is printed."""
    from unittest import mock as _mock
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.infer import RRDBNET_X4
    from image_restoration_tpu_torch.ops import int8_conv
    from image_restoration_tpu_torch.ops import rrdb_quant as rq
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = build_network(dict(RRDBNET_X4, num_block=2),
                            torch.Generator().manual_seed(0)).cuda().eval()
        q = rq.quantize_rrdb_params(net, rq.calibrate_rrdb_act_scales(
            net, torch.from_numpy(rrdb_calib()).cuda()))
        s = RRDB_SIZE
        x = torch.from_numpy(scene_image(s, s, seed=34)).cuda().float() / 255
        x = x[None]
        seen = []
        real = int8_conv.int8_conv3x3_rrdb_stage

        def record(t, *a, **k):
            out = real(t, *a, **k)
            seen.append((t, out))
            return out

        with _mock.patch.object(rq, "int8_conv3x3_rrdb_stage", record):
            got = rq.quantized_rrdb_forward(q, x, 2)
        torch.cuda.synchronize()
        require(len(seen) == 2 * K2_STAGE_LAUNCHES, f"{len(seen)} K2 calls")
        stage = iter(range(len(seen)))

        def compare(t, *a, **k):
            i = next(stage)
            require(torch.equal(t, seen[i][0]), f"stage input {i} differs")
            out = int8_conv.int8_conv3x3_rrdb_stage_plain(t, *a, **k)
            require(all((o is None and s is None) or torch.equal(o, s)
                        for o, s in zip(out, seen[i][1])),
                    f"stage {i}: K2 vs plain output differs")
            seen[i] = None
            return out

        with _mock.patch.object(rq, "int8_conv3x3_rrdb_stage", compare):
            want = rq.quantized_rrdb_forward(q, x, 2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "int8 RRDB output: K2 vs plain")
        log(f"int8 RRDB chain (2 blocks, {s}², TF32 off) on K2 vs on plain "
            "K2: 30 stage inputs and outputs equal, bf16 output bit-equal")
        del seen, got, want

        y = torch.from_numpy(scene_image(256, 256, seed=35)).cuda()
        y = y[None].float() / 255
        for name, nt, qq, nb in (("2 blocks", net, q, 2),
                                 ("23 blocks", net23, q23, 23)):
            dtype, nt.dtype = nt.dtype, None  # the float32 forward
            try:
                with torch.no_grad():
                    ref = nt(y)
            finally:
                nt.dtype = dtype
            db = span_psnr(ref, rq.quantized_rrdb_forward(qq, y, nb))
            log(f"int8 RRDB ({name}) vs the float32 forward, 256² synthetic "
                f"scene: span-normalized PSNR {db:.2f} dB"
                + (f" (gate >= {RRDB_GATE_DB})" if nb == 2 else
                   " (no gate)"))
            res[f"int8_vs_f32_db_{nb}"] = db
        require(res["int8_vs_f32_db_2"] >= RRDB_GATE_DB,
                f"int8 RRDB vs f32: {res['int8_vs_f32_db_2']:.2f} dB")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.empty_cache()
    return res


# ------------------------------------------- path 4: the product pipeline

PIPE_TARGET = 256
DET_SIZE = 224
DET_TOL = 1e-3              # card vs CPU, × max(1, max|CPU|)
# a plate-like quad on the 256² canvas, [p1, p2, p5, p4] (TL, TR, BR, BL)
PINNED_QUAD = np.array([[40, 88], [208, 72], [216, 176], [32, 188]],
                       np.int32)
PIPE_CHUNK = 8
PIPE_BATCH = 16


def car_photo(seed, h=480, w=640):
    """A synthetic 640×480 BGR uint8 car photo (scene_image: a street-like
    scene with a licence plate)."""
    return np.ascontiguousarray(scene_image(h, w, seed)[..., ::-1])


@torch.no_grad()
def calibrate_detector(det, seed):
    """Random conv weights leave BatchNorm at identity statistics, and the
    0–255 input then saturates the class softmax (hundreds of scores equal
    1.0, ties everywhere). Set each BatchNorm's running statistics to those
    of its own input on two synthetic scenes, in one pass in layer order, as
    a trained detector's would be: the scores spread out."""
    import cv2
    s = det.image_size
    cal = np.stack([cv2.resize(car_photo(seed + i), (s, s))
                    for i in range(2)]).astype(np.float32)

    def hook(m, inp):
        v = inp[0].float()
        m.running_mean.copy_(v.mean((0, 2, 3)))
        m.running_var.copy_(v.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(hook) for m in det.net.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        det.net(torch.from_numpy(cal).to(det.device) - det._mean)
    finally:
        for h in hooks:
            h.remove()


def build_detector(backbone, device, seed=0, like=None):
    """PlateDetector(backbone) at 224² with calibrated statistics, or with
    `like`'s weights."""
    from image_restoration_tpu_torch.detect.engine import PlateDetector
    det = PlateDetector(backbone=backbone, image_size=DET_SIZE,
                        device=device, seed=seed)
    if like is None:
        calibrate_detector(det, seed=60)
    else:
        det.net.load_state_dict(like.net.state_dict())
    return det


def phase_detector():
    """Resnet18 at 224² on the card against the CPU (TF32 off): raw outputs
    within 1e-3·max(1, max|CPU|), then the NMS order and the kept entries
    of the detector's output. The other three backbones once at batch 8,
    also held against the CPU. ms per detect call at batch 1 and 8, and
    NMS's share of it."""
    import cv2
    from image_restoration_tpu_torch.detect.box_utils import decode, nms
    res = {}
    imgs = np.stack([cv2.resize(car_photo(70 + i), (DET_SIZE, DET_SIZE))
                     for i in range(8)]).astype(np.float32)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for bb in ("Resnet18", "Resnet50", "mobilenet0.25", "MobilenetV3"):
            gpu = build_detector(bb, "cuda")
            cpu = build_detector(bb, "cpu", like=gpu)
            n = 2 if bb == "Resnet18" else 8
            x = torch.from_numpy(imgs[:n])
            with torch.no_grad():
                want = cpu.net(x - cpu._mean)
                got = gpu.net(x.cuda() - gpu._mean)
            errs = []
            for name, w, g in zip(("loc", "conf", "landm"), want, got):
                require(bool(torch.isfinite(g).all()), f"{bb} {name} finite")
                err = (g.cpu() - w).abs().max().item()
                lim = DET_TOL * max(1.0, w.abs().max().item())
                require(err <= lim, f"{bb} {name}: card vs CPU {err} > {lim}")
                errs.append(err)
            log(f"detector {bb} bs={n} card vs CPU (TF32 off): max|d| "
                f"loc/conf/landm {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}")
            res[f"{bb}_card_vs_cpu"] = errs
            if bb != "Resnet18":
                out = gpu(imgs)
                require(out[0].shape == (8, 20, 4) and out[3].shape == (8, 20),
                        f"{bb} detect: {out[0].shape}")
                res[f"{bb}_ms_bs8"] = median_ms(
                    lambda: gpu.detect(torch.from_numpy(imgs).cuda()), 10)[0]
                log(f"detector {bb} bs=8: {res[f'{bb}_ms_bs8']:.3f} ms per "
                    "detect call")
                continue
            orders = []
            for det, (loc, conf, _) in ((cpu, want), (gpu, got)):
                boxes = decode(loc, det.priors, det.cfg["variance"])
                orders.append(nms(boxes, conf[..., 1], det.iou_threshold,
                                  det.top_k, det.score_threshold))
            k = gpu.keep_top_k
            (_, _, keep_c, order_c), (_, _, keep_g, order_g) = orders
            require(torch.equal(order_g.cpu()[:, :k], order_c[:, :k]),
                    "Resnet18 NMS order: card vs CPU")
            require(torch.equal(keep_g.cpu()[:, :k], keep_c[:, :k]),
                    "Resnet18 NMS keep: card vs CPU")
            same = (order_g.cpu() == order_c).float().mean().item()
            outs_c, outs_g = cpu(imgs[:2]), gpu(imgs[:2])
            require(np.array_equal(outs_c[3], outs_g[3]), "valid differs")
            for name, c, g in zip(("boxes", "scores", "landms"), outs_c,
                                  outs_g):
                err = float(np.abs(c - g).max())
                require(err <= DET_TOL, f"detector {name}: {err}")
            log(f"detector Resnet18 card vs CPU: NMS order and keep equal in "
                f"the first {k} (of 200: {100 * same:.1f}% equal), valid "
                "equal, boxes/scores/landms within 1e-3")
            det18 = gpu
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for bs in (1, 8):
        x = torch.from_numpy(imgs[:bs]).cuda()
        det_ms, lo, hi = median_ms(lambda: det18.detect(x), 20)
        with torch.no_grad():
            loc, conf, _ = det18.net(x - det18._mean)
        boxes = decode(loc, det18.priors, det18.cfg["variance"])
        nms_ms = median_ms(lambda: nms(
            boxes, conf[..., 1], det18.iou_threshold, det18.top_k,
            det18.score_threshold), 20)[0]
        res[f"Resnet18_ms_bs{bs}"] = det_ms
        res[f"nms_ms_bs{bs}"] = nms_ms
        log(f"detector Resnet18 224² bs={bs}: {det_ms:.3f} ms per detect "
            f"call (min {lo:.3f}, max {hi:.3f}), NMS {nms_ms:.3f} ms "
            f"({100 * nms_ms / det_ms:.1f}%)")
    del det18, gpu, cpu
    torch.cuda.empty_cache()
    return res


def build_pipeline():
    """PlatePipeline at its defaults on the card (Resnet18 at 224², two
    Restorer(PRODUCTION_GFPGAN), seed 0), the detector's statistics
    calibrated and the restorers' biases drawn as in path 1."""
    from image_restoration_tpu_torch.serve.pipeline import PlatePipeline
    pipe = PlatePipeline(detector=build_detector("Resnet18", "cuda"),
                         device="cuda", seed=0)
    for r in (pipe.plate_restorer, pipe.car_restorer):
        randomize_weights(r.net, seed=1)
    return pipe


def phase_pipeline_main_path(pipe):
    """Counts at 0; `process` on one 640×480 photo and `process_batch` on 16
    in chunks of 8, each on the host and the device geometry path, then one
    POST to /Vehicle_Resolution_GFPGAN/. Two GFPGAN forwards per image or
    chunk (plate and car are two restorers): K1 must launch 39 times each,
    K2 and K3 never."""
    import cv2
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
    t = PIPE_TARGET
    photo = car_photo(80)
    photos = [car_photo(81 + i) for i in range(PIPE_BATCH)]
    kernels = _counts_zero()
    k1 = kernels[0]
    forwards = 0

    def step(name, fn, n_fwd):
        nonlocal forwards
        before = k1.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        n = k1.launches - before
        require(n == K1_LAUNCHES_PER_FORWARD * n_fwd,
                f"{name}: K1 launched {n} times, expected "
                f"{K1_LAUNCHES_PER_FORWARD * n_fwd}")
        forwards += n_fwd
        log(f"{name}: {dt:.1f} ms (first call), K1 launches {n}")
        return out

    def check(res, name):
        m = res["montage"]
        require(m.dtype == np.uint8 and m.shape == (t, 6 * t, 3),
                f"{name}: montage {m.dtype} {m.shape}")
        require(res["quad"].shape == (4, 2) and np.isfinite(res["score"]),
                f"{name}: quad/score")

    detected = 0
    for geo in (False, True):
        pipe.device_geometry = geo
        path = "device" if geo else "host"
        check(step(f"process 640x480 ({path} geometry)",
                   lambda: pipe.process(photo), 2), "process")
        outs = step(f"process_batch {PIPE_BATCH} in chunks of {PIPE_CHUNK} "
                    f"({path} geometry)",
                    lambda: pipe.process_batch(photos, PIPE_CHUNK),
                    2 * PIPE_BATCH // PIPE_CHUNK)
        require(len(outs) == PIPE_BATCH, f"process_batch: {len(outs)}")
        for o in outs:
            check(o, "process_batch")
        detected = sum(o["detected"] for o in outs)
    pipe.device_geometry = False
    core = ServiceCore(pipeline=pipe)
    server = make_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ok, buf = cv2.imencode(".jpg", photo)
        require(ok, "JPEG encode")
        status, media, body = step(
            "POST /Vehicle_Resolution_GFPGAN/ 640x480 jpeg",
            lambda: post(server.server_address[1],
                         "/Vehicle_Resolution_GFPGAN/", buf.tobytes()), 2)
        img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        require(status == 200 and media == "image/png" and img is not None
                and img.shape == (t, 6 * t, 3),
                f"/Vehicle_Resolution_GFPGAN/: {status} {media}")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    launches = [k.launches for k in kernels]
    require(launches[0] == K1_LAUNCHES_PER_FORWARD * forwards
            and launches[1:] == [0, 0],
            f"pipeline path: K1/K2/K3 launches {launches}, {forwards} "
            "forwards")
    log(f"pipeline main path: {forwards} GFPGAN forwards, K1 launches "
        f"{launches[0]} (K2, K3: 0); {detected} of {PIPE_BATCH} photos "
        "detected (random weights)")
    return launches[0], forwards


def phase_pipeline_correctness(pipe):
    """TF32 off, the detector's quad pinned: the device geometry path
    against the host path on the card (the thresholds of
    tests/test_serve.py), and the card against the CPU on each path
    (montage ≤4 LSB max, ≤0.05 mean, as phase 5)."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.serve.pipeline import PlatePipeline
    photo = car_photo(90)
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pinned = mock.patch.object(PlatePipeline, "_detect_quad",
                               lambda self, im: (PINNED_QUAD.copy(), 0.9,
                                                 True))
    try:
        cpu_r = []
        for r in (pipe.plate_restorer, pipe.car_restorer):
            c = Restorer(PRODUCTION_GFPGAN, device="cpu")
            c.net.load_state_dict(r.net.state_dict())
            cpu_r.append(c)
        cpu = PlatePipeline(
            detector=build_detector("Resnet18", "cpu", like=pipe.detector),
            plate_restorer=cpu_r[0], car_restorer=cpu_r[1])
        with pinned:
            outs = {}
            for geo in (False, True):
                for name, p in (("card", pipe), ("cpu", cpu)):
                    p.device_geometry = geo
                    outs[(name, geo)] = p.process(photo)
            pipe.device_geometry = False
        host, dev = outs[("card", False)], outs[("card", True)]
        for key in ("crop", "crop_padded", "transform"):
            d = np.abs(dev[key].astype(np.float32)
                       - host[key].astype(np.float32))
            q90, mean = float(np.quantile(d, 0.9)), float(d.mean())
            log(f"device vs host geometry on the card, {key}: q90 {q90} "
                f"mean {mean:.4f} (limits 2, 8)")
            require(q90 <= 2.0 and mean <= 8.0, f"geometry {key}")
            res[f"geo_{key}_mean"] = mean
        for key in ("plate_restored", "car_restored", "pasted"):
            mean = float(np.abs(dev[key].astype(np.float32)
                                - host[key].astype(np.float32)).mean())
            log(f"device vs host geometry on the card, {key}: mean "
                f"{mean:.4f} (limit 12)")
            require(mean <= 12.0, f"geometry {key}: mean {mean}")
            res[f"geo_{key}_mean"] = mean
        for geo in (False, True):
            a = outs[("card", geo)]["montage"].astype(np.int16)
            b = outs[("cpu", geo)]["montage"].astype(np.int16)
            d = np.abs(a - b)
            path = "device" if geo else "host"
            log(f"pipeline card vs CPU ({path} geometry, TF32 off): montage "
                f"max {d.max()} LSB, mean {d.mean():.5f}")
            require(d.max() <= 4 and d.mean() <= 0.05,
                    f"pipeline card vs CPU ({path}): {d.max()} {d.mean()}")
            res[f"card_vs_cpu_{path}_lsb"] = int(d.max())
            res[f"card_vs_cpu_{path}_mean"] = float(d.mean())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return res


def phase_pipeline_throughput(pipe):
    """images/s of process_batch in chunks of 8 on each geometry path, the
    "auto" choice, ms per /Vehicle_Resolution_GFPGAN/ request and its PNG
    encode, peak device memory, and a profile of one chunk on each path
    (device-busy share). PyTorch's default TF32 settings."""
    import cv2
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
    from image_restoration_tpu_torch.serve.pipeline import PlatePipeline
    photos = [car_photo(100 + i) for i in range(2 * PIPE_BATCH)]
    res = {}
    for geo in (False, True):
        path = "device" if geo else "host"
        pipe.device_geometry = geo
        med, lo, hi = median_ms(
            lambda: pipe.process_batch(photos, PIPE_CHUNK), 3)
        res[f"{path}_imgs_per_s"] = len(photos) / med * 1e3
        torch.cuda.reset_peak_memory_stats()
        pipe.process_batch(photos[:PIPE_CHUNK], PIPE_CHUNK)
        res[f"{path}_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        log(f"process_batch {len(photos)} photos, chunks of {PIPE_CHUNK}, "
            f"{path} geometry: {res[f'{path}_imgs_per_s']:.2f} imgs/s "
            f"(median {med:.1f} ms, min {lo:.1f}, max {hi:.1f}), peak "
            f"{res[f'{path}_peak_mib']:.1f} MiB")
        want = 2 * K1_LAUNCHES_PER_FORWARD
        wall, kernels, k1_n = profile_call(
            lambda: pipe.process_batch(photos[:PIPE_CHUNK], PIPE_CHUNK),
            "fused_bias_lrelu", want)
        busy = sum(k[0] for k in kernels)
        log(f"profile of one chunk of {PIPE_CHUNK} ({path} geometry): wall "
            f"{wall:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f}%), K1 launches {k1_n}")
        for tk, n, name in kernels[:8]:
            log(f"  {tk:9.4f} ms  x{n:<4d} {name[:110]}")
        require(k1_n == want, f"profiler saw {k1_n} K1 launches")
        res[f"{path}_profile"] = dict(wall_ms=wall, busy_ms=busy, top=[
            dict(ms=tk, count=n, name=name[:200])
            for tk, n, name in kernels[:10]])
    pipe.device_geometry = False
    auto = PlatePipeline(detector=pipe.detector,
                         plate_restorer=pipe.plate_restorer,
                         car_restorer=pipe.car_restorer,
                         device_geometry="auto")
    auto.process_batch(photos[:PIPE_BATCH], PIPE_CHUNK)
    res["auto_ms_per_image"] = auto.geo_auto_ms_per_image
    res["auto_choice"] = "device" if auto.device_geometry else "host"
    log(f"device_geometry='auto' at chunk {PIPE_CHUNK}: "
        f"{auto.geo_auto_ms_per_image} ms/img -> {res['auto_choice']}")

    core = ServiceCore(pipeline=pipe)
    server = make_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ok, buf = cv2.imencode(".jpg", photos[0])
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            status, _, body = post(server.server_address[1],
                                   "/Vehicle_Resolution_GFPGAN/",
                                   buf.tobytes())
            times.append((time.perf_counter() - t0) * 1e3)
            require(status == 200, f"/Vehicle_Resolution_GFPGAN/: {status}")
        montage = pipe.process(photos[0])["montage"]
        enc = []
        for _ in range(6):
            t0 = time.perf_counter()
            cv2.imencode(".png", montage)
            enc.append((time.perf_counter() - t0) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    res["request_ms"] = float(np.median(times[1:]))
    res["png_encode_ms"] = float(np.median(enc[1:]))
    log(f"POST /Vehicle_Resolution_GFPGAN/ 640x480: median "
        f"{res['request_ms']:.2f} ms over 5 (after one warm-up), PNG encode "
        f"of the 1536x256 montage {res['png_encode_ms']:.2f} ms")
    return res


# ----------------------------- path 5: exported engines and dynamic int8

ENGINE_BATCH = 32           # export_gfpgan's default batch
GEO_BATCH = 8
DYN_INT8_GATE_DB = 30.0     # tests/test_serve.py:206-217's gate
SPEED_BATCHES = (32,)        # bs 8 cut for path 14, bs 1 for path 15


def _tf32_off():
    """Turn TF32 off for a comparison; returns the settings to restore."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return old


def _tf32_restore(old):
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _psnr_u8(a, b):
    mse = float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def _lsb(a, b):
    require(a.dtype == b.dtype == np.uint8 and a.shape == b.shape,
            f"compare {a.dtype}{a.shape} with {b.dtype}{b.shape}")
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def save_pth(net, path):
    """A reference-layout .pth ({'params_ema': state_dict}) of net."""
    torch.save({"params_ema": {k: v.detach().cpu()
                               for k, v in net.state_dict().items()}}, path)
    return str(path)


def phase_export(restorer, pipe, tmp):
    """Export on the card into tmp, through the exporters' entry points:
    the GFPGAN u8 engine at PRODUCTION_GFPGAN (path 1's weights) at batch 32
    in float32 and in dyn-int8, and at batch 1; the geometry engine at
    batch 8 (the pipeline's weights);
    the SR engine at export_restorer's defaults with --u8-io (path 2's
    calibration). Each is checked against its live graph before it is
    written (the exporters' round trip). Returns {name: (dir, record)}."""
    from image_restoration_tpu_torch.scripts import export_gfpgan
    from image_restoration_tpu_torch.scripts import export_restorer
    from image_restoration_tpu_torch.serve.engine_restorer import save_engine

    pth = save_pth(restorer.net, os.path.join(tmp, "gfpgan.pth"))
    geo_pth = save_pth(pipe.plate_restorer.net,
                       os.path.join(tmp, "pipeline.pth"))
    specs = [("gfpgan_bs32", dict(pth=pth, batch=ENGINE_BATCH)),
             ("gfpgan_dyn_int8_bs32", dict(pth=pth, batch=ENGINE_BATCH,
                                           quant="dyn-int8")),
             ("gfpgan_bs1", dict(pth=pth, batch=1)),
             ("geometry_bs8", dict(pth=geo_pth, batch=GEO_BATCH,
                                   with_geometry=True))]
    out = {}
    for name, kw in specs:
        t0 = time.perf_counter()
        program, meta, live, _ = export_gfpgan.build_engine(device="cuda",
                                                            **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        db = export_gfpgan.round_trip_db(program.module(), live, meta)
        d = os.path.join(tmp, name)
        nbytes = save_engine(d, program, meta)
        t2 = time.perf_counter()
        out[name] = (d, dict(export_s=t1 - t0, round_trip_db=db,
                             save_s=t2 - t1, mib=nbytes / 2 ** 20))
        log(f"export {name}: traced in {t1 - t0:.2f} s, round trip "
            f"{db:.1f} dB, written in {t2 - t1:.2f} s, "
            f"{nbytes / 2 ** 20:.1f} MiB")
        require(db >= 30.0, f"{name}: round trip {db:.1f} dB")
        del program, live
    t0 = time.perf_counter()
    program, meta, serve = export_restorer.build_engine(
        calib=sr_calib(), seed=0, io="u8", device="cuda", **SR)
    t1 = time.perf_counter()
    size = SR["tile"] + 2 * SR["halo"]
    x = torch.from_numpy((np.random.default_rng(0).random(
        (SR["batch"], size, size, 3)) * 255).astype(np.uint8)).cuda()
    db = export_restorer.round_trip_db(serve, program.module(), x)
    d = os.path.join(tmp, "sr_u8")
    nbytes = save_engine(d, program, meta)
    t2 = time.perf_counter()
    out["sr_u8"] = (d, dict(export_s=t1 - t0, round_trip_db=db,
                            save_s=t2 - t1, mib=nbytes / 2 ** 20))
    log(f"export sr_u8 ({meta['mode']}, io {meta['io']}, "
        f"{meta['input_shape']}): traced in {t1 - t0:.2f} s, round trip "
        f"{db:.1f} dB, written in {t2 - t1:.2f} s, {nbytes / 2 ** 20:.2f} "
        "MiB")
    require(db >= 30.0, f"sr_u8: round trip {db:.1f} dB")
    torch.cuda.empty_cache()
    return out


def phase_artifact_main_path(restorer, pipe, exported):
    """TF32 off, counts at 0: every artifact loaded as a server loads it
    and held against the live object it was exported from. The GFPGAN
    engine against `Restorer.restore_batch_u8` (≤1 LSB; K1 39 per forward
    through the artifact), the dyn-int8 engine against a dyn-int8
    Restorer, `PlatePipeline(geo_engine=EngineGeoPipeline)` against the
    live device-geometry path (montage ≤1 LSB), the SR artifact against
    `EngineRestorer.build` on a 1024×768 photo (bit-equal; K2 34 per chunk,
    K1 never), then one /SRx4/ POST through IRT_SR_ENGINE and one /Restore/
    POST through ServiceCore(restorer=EngineFaceRestorer). Returns (K1, K2)
    launches and the report."""
    import cv2
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
    from image_restoration_tpu_torch.serve.engine_restorer import (
        EngineFaceRestorer, EngineGeoPipeline, EngineRestorer)
    from image_restoration_tpu_torch.serve.pipeline import PlatePipeline

    res = {}
    old = _tf32_off()
    k1, k2, k3 = _counts_zero()
    try:
        def counted(name, fn, want_k1, want_k2=0):
            b1, b2 = k1.launches, k2.launches
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            n1, n2 = k1.launches - b1, k2.launches - b2
            require((n1, n2) == (want_k1, want_k2),
                    f"{name}: K1/K2 launched {n1}/{n2}, expected "
                    f"{want_k1}/{want_k2}")
            log(f"{name}: {dt:.1f} ms, K1 {n1}, K2 {n2}")
            return got

        u8 = np.stack([plate_image(256, 256, seed=200 + i)[..., ::-1]
                       for i in range(ENGINE_BATCH)])
        for name, live in (("gfpgan_bs32", restorer),
                           ("gfpgan_dyn_int8_bs32", None)):
            t0 = time.perf_counter()
            eng = EngineFaceRestorer(exported[name][0], device="cuda")
            load_s = time.perf_counter() - t0
            if live is None:
                live = Restorer(PRODUCTION_GFPGAN, quant="dyn-int8",
                                device="cuda")
                live.net.load_state_dict(restorer.net.state_dict())
            got = counted(f"{name} artifact, {ENGINE_BATCH} images",
                          lambda: eng.restore_batch_u8(u8),
                          K1_LAUNCHES_PER_FORWARD)
            want = counted(f"{name} live Restorer",
                           lambda: live.restore_batch_u8(u8),
                           K1_LAUNCHES_PER_FORWARD)
            d = _lsb(got, want)
            log(f"{name} artifact vs live (TF32 off): max {d} LSB, loaded "
                f"in {load_s:.2f} s")
            require(d <= 1, f"{name} artifact vs live: {d} LSB")
            res[name] = dict(lsb=d, load_s=load_s)
        face = EngineFaceRestorer(exported["gfpgan_bs32"][0], device="cuda")

        # the geometry engine in the pipeline, against the live fused path
        geo = EngineGeoPipeline(exported["geometry_bs8"][0], device="cuda")
        served = PlatePipeline(detector=pipe.detector, geo_engine=geo)
        require(served.device_geometry and served.plate_restorer is None,
                "PlatePipeline(geo_engine=…) built restorers")
        photos = [car_photo(300 + i) for i in range(GEO_BATCH)]
        pipe.device_geometry = True
        want = counted("live device-geometry process_batch, chunk of 8",
                       lambda: pipe.process_batch(photos, GEO_BATCH),
                       2 * K1_LAUNCHES_PER_FORWARD)
        got = counted("geo_engine process_batch, chunk of 8",
                      lambda: served.process_batch(photos, GEO_BATCH),
                      K1_LAUNCHES_PER_FORWARD)
        pipe.device_geometry = False
        d = max(_lsb(g["montage"], w["montage"]) for g, w in zip(got, want))
        log(f"geometry artifact vs live fused path (TF32 off): montage max "
            f"{d} LSB over {GEO_BATCH} photos")
        require(d <= 1, f"geometry artifact vs live: {d} LSB")
        res["geometry_lsb"] = d

        # the SR artifact against the in-process build
        live_sr = build_sr(int8=True)
        art_sr = EngineRestorer(exported["sr_u8"][0], device="cuda")
        img = scene_image(768, 1024, seed=21)
        got = counted("SR artifact, 1024x768", lambda: art_sr(img),
                      0, K2_LAUNCHES_PER_CALL)
        want = counted("SR EngineRestorer.build, 1024x768",
                       lambda: live_sr(img), 0, K2_LAUNCHES_PER_CALL)
        require(np.array_equal(got, want), "SR artifact != build: "
                f"{_lsb(got, want)} LSB")
        log("SR artifact vs EngineRestorer.build: bit-equal "
            f"{got.shape[1]}x{got.shape[0]}")
        del live_sr

        # the server: /SRx4/ through IRT_SR_ENGINE, /Restore/ through the
        # exported face engine
        os.environ["IRT_SR_ENGINE"] = exported["sr_u8"][0]
        try:
            core = ServiceCore(restorer=face)
        finally:
            del os.environ["IRT_SR_ENGINE"]
        require(isinstance(core.sr_engine, EngineRestorer),
                "IRT_SR_ENGINE did not load")
        server = make_server(core, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            bgr = np.ascontiguousarray(scene_image(360, 640, seed=22)[
                ..., ::-1])
            ok, png = cv2.imencode(".png", bgr)
            status, media, body = counted(
                "POST /SRx4/ 640x360 through IRT_SR_ENGINE",
                lambda: post(port, "/SRx4/", png.tobytes()), 0,
                K2_LAUNCHES_PER_CALL)
            out = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and out is not None
                    and out.shape == (1440, 2560, 3), f"/SRx4/: {status}")
            ok, jpg = cv2.imencode(".jpg", plate_image(120, 360, seed=301))
            status, media, body = counted(
                "POST /Restore/ through EngineFaceRestorer",
                lambda: post(port, "/Restore/", jpg.tobytes()),
                K1_LAUNCHES_PER_FORWARD)
            out = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and out is not None
                    and out.shape == (256, 256, 3), f"/Restore/: {status}")
        finally:
            server.shutdown()
            server.server_close()
            core.close()
            thread.join(timeout=30)
        require(not thread.is_alive(), "server thread did not stop")
    finally:
        _tf32_restore(old)
    launches = (k1.launches, k2.launches)
    require(k3.launches == 0, f"K3 launched {k3.launches} times")
    log(f"artifact main path: K1 launches {launches[0]}, K2 {launches[1]}, "
        "K3 0")
    return launches, res


def _dyn_int8_profile(q, u8):
    """Device time of one batch-32 dyn-int8 restore, by part: the int8
    GEMM (`aten::_int_mm`), the im2col and quantize passes (their
    functions wrapped in profiler ranges for this call only), K1, and the
    rest."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from image_restoration_tpu_torch.ops import modulated_conv as mc

    def ranged(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    parts = {"irt.im2col": "_im2col", "irt.quant_act": "_dyn_quant",
             "irt.quant_weight": "_quant_weight"}
    patches = [mock.patch.object(mc, attr, ranged(name, getattr(mc, attr)))
               for name, attr in parts.items()]
    for p in patches:
        p.start()
    try:
        q.restore_batch_u8(u8)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                q.restore_batch_u8(u8)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # the ranges also appear on the device's timeline: keep kernels
            kernels = [k for k in _kernel_events(prof) if k[2] not in parts]
            k1_n = sum(k[1] for k in kernels if "fused_bias_lrelu" in k[2])
            if k1_n == K1_LAUNCHES_PER_FORWARD:
                break
            log(f"profiler saw {k1_n} K1 launches: profiling again")
    finally:
        for p in patches:
            p.stop()
    require(k1_n == K1_LAUNCHES_PER_FORWARD,
            f"dyn-int8 profile: {k1_n} K1 launches")
    busy = sum(k[0] for k in kernels)

    def op_ms(key):
        """Device time of the kernels launched inside the host-side op or
        range `key`."""
        return sum(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)) / 1e3
                   for e in prof.key_averages()
                   if e.key == key and getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU)

    shares = {"int_mm": op_ms("aten::_int_mm"),
              "im2col": op_ms("irt.im2col"),
              "quantize": op_ms("irt.quant_act") + op_ms("irt.quant_weight"),
              "k1": sum(k[0] for k in kernels if "fused_bias_lrelu" in k[2])}
    shares["other"] = busy - sum(shares.values())
    log(f"profile dyn-int8 bs={u8.shape[0]}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
    for k, v in shares.items():
        log(f"  {k:9s} {v:9.3f} ms  {100 * v / busy:5.1f}% of busy")
    for t, n, name in kernels[:12]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    return dict(wall_ms=wall, busy_ms=busy, ms=shares,
                share={k: v / busy for k, v in shares.items()},
                top=[dict(ms=t, count=n, name=name[:200])
                     for t, n, name in kernels[:20]])


def phase_dyn_int8(restorer, exported):
    """Restorer(quant="dyn-int8") at PRODUCTION_GFPGAN on the card: the
    card against the CPU on one image and the uint8 path against the float
    path (≥ 30 dB, TF32 off); imgs/s and peak MiB of float32, bf16 and
    dyn-int8 at SPEED_BATCHES (PyTorch's default TF32 settings); a
    profile of one batch-32 dyn-int8 restore; and ms per call of the
    exported module against the eager Restorer at batch 1 and 32."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.serve.engine_restorer import load_engine

    sd = restorer.net.state_dict()
    q = Restorer(PRODUCTION_GFPGAN, quant="dyn-int8", device="cuda")
    q.net.load_state_dict(sd)
    imgs = np.stack([plate_image(256, 256, seed=400 + i)[..., ::-1]
                     for i in range(max(SPEED_BATCHES))])
    res = {}
    old = _tf32_off()
    try:
        qc = Restorer(PRODUCTION_GFPGAN, quant="dyn-int8", device="cpu")
        qc.net.load_state_dict(sd)
        a, b = q.restore_batch_u8(imgs[:1]), qc.restore_batch_u8(imgs[:1])
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        res["card_vs_cpu"] = dict(lsb=int(d.max()), mean=float(d.mean()),
                                  db=_psnr_u8(a, b))
        log(f"dyn-int8 card vs CPU (bs=1, TF32 off): max {d.max()} LSB, "
            f"mean {d.mean():.5f}, {res['card_vs_cpu']['db']:.2f} dB")
        require(res["card_vs_cpu"]["db"] >= DYN_INT8_GATE_DB,
                f"dyn-int8 card vs CPU {res['card_vs_cpu']['db']:.2f} dB")
        del qc
        u8 = imgs[:8]
        got = q.restore_batch_u8(u8)
        db = _psnr_u8(got, q.restore_batch(u8.astype(np.float32) / 255.0))
        f32 = _psnr_u8(got, restorer.restore_batch_u8(u8))
        res["u8_vs_float_path_db"], res["vs_float32_db"] = db, f32
        log(f"dyn-int8 uint8 path vs its float path (bs=8): {db:.2f} dB "
            f"(gate {DYN_INT8_GATE_DB}); dyn-int8 vs float32 Restorer: "
            f"{f32:.2f} dB")
        require(db >= DYN_INT8_GATE_DB, f"dyn-int8 u8 vs float {db:.2f} dB")
    finally:
        _tf32_restore(old)

    bf = Restorer(PRODUCTION_GFPGAN, dtype=torch.bfloat16, device="cuda")
    bf.net.load_state_dict(sd)
    modes = {"float32": restorer, "bf16": bf, "dyn-int8": q}
    speed = {}
    for mode, r in modes.items():
        for bs in SPEED_BATCHES:
            u8 = imgs[:bs]
            med, lo, hi = median_ms(lambda: r.restore_batch_u8(u8),
                                    {1: 20, 8: 10, 32: 6}[bs])
            torch.cuda.reset_peak_memory_stats()
            r.restore_batch_u8(u8)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            speed[f"{mode}_bs{bs}"] = dict(imgs_per_s=bs / med * 1e3,
                                           ms=med, ms_min=lo, ms_max=hi,
                                           peak_mib=peak)
            log(f"restore_batch_u8 {mode} bs={bs}: {bs / med * 1e3:.2f} "
                f"imgs/s (median {med:.3f} ms, min {lo:.3f}, max {hi:.3f}), "
                f"peak {peak:.1f} MiB")
    res["speed"] = speed
    del bf
    res["profile"] = _dyn_int8_profile(q, imgs[:ENGINE_BATCH])

    # the artifact's host cost: the loaded module against the eager graph
    # on the same device tensors
    host = {}
    for bs, name in ((ENGINE_BATCH, "gfpgan_bs32"),):
        module, _ = load_engine(exported[name][0], "cuda")
        x = torch.from_numpy(imgs[:bs]).cuda()
        with torch.inference_mode():
            art = median_ms(lambda: module(x), 20)[0]
            eager = median_ms(lambda: restorer._fwd_u8(x), 20)[0]
        host[f"bs{bs}"] = dict(artifact_ms=art, eager_ms=eager)
        log(f"exported module vs eager Restorer, bs={bs}: {art:.3f} vs "
            f"{eager:.3f} ms per call")
        del module
    res["artifact_vs_eager"] = host
    torch.cuda.empty_cache()
    return res


# ------------------------------------------ path 6: the GFPGAN GAN trainer

TRAIN_CONFIG = "configs/train_gfpgan_plate_256.yml"
# K1 at 256² in D (channel multiplier 1): conv_body's 1×1 ConvLayer, two
# in each of 6 ResBlocks, final_conv and final_linear's first layer
K1_PER_D_FORWARD = 15
# a G+D step: G (39), D on its output in the G loss, D on fake and real
K1_PER_GD_STEP = K1_LAUNCHES_PER_FORWARD + 3 * K1_PER_D_FORWARD
K1_PER_R1_STEP = K1_PER_D_FORWARD   # the double backward launches none
TRAIN_ITERS = 32                    # R1 at 16 and 32
TRAIN_SPEED_BATCHES = (4,)          # bs 16 cut to make room for path 14
# steps of every re-timed training loop (paths 6-11: the median of steps
# 5-16); 32 before path 15
TIMED_STEPS = 16
FIR_KERNEL_KEYS = ("conv2d_grouped_direct", "dgrad2d_c1_k1")
TRAIN_VAL_IMAGES = 4
LOSS_RTOL = 1e-5                    # kernel vs plain, card vs CPU
GRAD_TOL = 1e-4                     # of max|grad|; 1e-4 of elements to 1e-3


def analytic_gfpgan_flops(bs, hw=256):
    """FLOPs of one GAN step, the estimate of `scripts/bench_train.py:320`
    (G fwd 85, D fwd 18, VGG19 fwd 51 GFLOP per 256² image; G fwd + 2×
    bwd, D ×2 fwd + bwd plus the fake forward in the G loss, VGG on two
    streams fwd and bwd through the output's)."""
    g_fwd, d_fwd, vgg_fwd = 85e9, 18e9, 51e9
    return bs * (g_fwd * 3 + d_fwd * 3 * 2 + d_fwd + vgg_fwd * 4)


def train_options(root):
    """argv for `train_pipeline` on the production config with its
    dataroots in `root`, cut to TRAIN_ITERS steps."""
    return ["-opt", TRAIN_CONFIG, "--force_yml",
            f"datasets:train:dataroot_gt={root}/train",
            f"datasets:val:dataroot_gt={root}/val",
            f"train:total_iter={TRAIN_ITERS}", f"val:val_freq={TRAIN_ITERS}",
            f"logger:save_checkpoint_freq={TRAIN_ITERS}",
            "logger:print_freq=8"]


def write_plates(folder, n, seed):
    import cv2
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"plate_{i:03d}.png"),
                    plate_image(256, 256, seed + i))


def plate_batch(n, seed):
    """(n, 256, 256, 3) RGB float [0, 1] synthetic plates."""
    return np.stack([plate_image(256, 256, seed + i)[..., ::-1]
                     for i in range(n)]).astype(np.float32) / 255.0


def build_trainer(root, bs=4, device="cuda"):
    """The production GFPGANModel (random weights from manual_seed, random
    VGG taps), with its degradation pipeline."""
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.utils.options import parse_options
    opt, _ = parse_options(root, argv=train_options(root))
    opt["datasets"]["train"]["batch_size_per_gpu"] = bs
    model = build_model(opt, device=device)
    model.set_degradation_pipeline(train_degradation(opt, root))
    return model, opt


def train_degradation(opt, root):
    """The training set's degradation pipeline, as the dataset derives it
    from its options (the dataset over `root`, whatever it holds)."""
    from image_restoration_tpu_torch.data import build_dataset
    return build_dataset(dict(opt["datasets"]["train"], dataroot_gt=root)) \
        .device_pipeline()


def _grads(net):
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            for p in net.parameters()]


def gan_pieces(model, lq, gt, noise, boxes=None):
    """Losses and gradients of one G+D step and one R1 step, pieces only
    (no optimizer update): G loss terms and G grads, the D loss and D
    grads at the detached output, R1 and its D grads; with the component
    Ds (`boxes` given), their per-char losses and grads at the detached
    output too."""
    comp = getattr(model, "use_facial_disc", False)
    ds = [model.net_d] + ([model.net_d_char] if comp else [])
    model.net_g.zero_grad(set_to_none=True)
    for d in ds:
        d.requires_grad_(False)
    total, losses, out = model.g_losses(lq, gt, noise, 1.0, boxes)
    total.backward()
    for d in ds:
        d.requires_grad_(True)
    g_grads = _grads(model.net_g)
    model.net_d.zero_grad(set_to_none=True)
    l_d, real_s, fake_s = model.d_loss(out.detach(), gt)
    l_d.backward()
    grads = dict(g=g_grads, d=_grads(model.net_d))
    if comp:
        model.net_d_char.zero_grad(set_to_none=True)
        per = model.component_d_losses(out.detach(), gt, boxes)
        per.sum().backward()
        grads["dc"] = _grads(model.net_d_char)
        model.net_d_char.zero_grad(set_to_none=True)
        losses.update({f"l_d_char_{i}": per[i] for i in range(len(per))})
    model.net_d.zero_grad(set_to_none=True)
    l_r1 = model.r1_loss(gt)
    l_r1.backward()
    grads["r1"] = _grads(model.net_d)
    model.net_g.zero_grad(set_to_none=True)
    model.net_d.zero_grad(set_to_none=True)
    losses = dict(losses, l_d=l_d, real_score=real_s, fake_score=fake_s,
                  l_d_r1=l_r1)
    return ({k: float(v.detach()) for k, v in losses.items()}, out.detach(),
            grads)


def compare_pieces(a, b, what):
    """Losses within LOSS_RTOL relative; each network's gradients within
    GRAD_TOL of its max|grad|, at most 1e-4 of elements up to 10×. Returns
    the worst loss and gradient differences."""
    worst_loss = 0.0
    for k, v in b[0].items():
        rel = abs(a[0][k] - v) / max(abs(v), 1e-12)
        worst_loss = max(worst_loss, rel)
        require(rel <= LOSS_RTOL, f"{what}: {k} {a[0][k]!r} vs {v!r}")
    worst_grad = {}
    for net, ga in a[2].items():
        gb = b[2][net]
        scale = max(float(g.abs().max()) for g in gb)
        over = total = 0
        worst = 0.0
        for x, y in zip(ga, gb):
            d = (x.float().cpu() - y.float().cpu()).abs()
            worst = max(worst, float(d.max()) / scale)
            over += int((d > GRAD_TOL * scale).sum())
            total += d.numel()
        worst_grad[net] = worst
        require(worst <= 10 * GRAD_TOL and over <= total * 1e-4,
                f"{what}: {net} grads, worst {worst:.3g} of max|grad|, "
                f"{over} of {total} elements over {GRAD_TOL}")
    dout = float((a[1].float().cpu() - b[1].float().cpu()).abs().max())
    log(f"{what}: losses worst {worst_loss:.3g} relative, output max|d| "
        f"{dout:.3g}, grads worst (of max|grad|) "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst_grad.items()))
    return dict(loss_rel=worst_loss, out_abs=dout, grad_rel=worst_grad)


def phase_train_degradation(root):
    """Phase 23: the production degradation's apply half on the card
    against the CPU at the same drawn parameters (bs 4, 256²), stage by
    stage and as a chain; then its device time at bs 4 and 16."""
    from image_restoration_tpu_torch.data import degradations as D
    from image_restoration_tpu_torch.utils.options import parse_options
    opt, _ = parse_options(root, argv=train_options(root))
    deg = train_degradation(opt, root)
    cfg = deg.cfg
    gen = torch.Generator().manual_seed(23)
    gt = torch.from_numpy(plate_batch(4, 2300))
    p = deg.sample(gen, 4, 256, 256)
    dev = torch.device("cuda")
    pc = D.params_to(p, dev)
    ksize = min(cfg.blur_kernel_size, 15)
    stages = {
        "blur kernel": lambda x, q, d: D.filter2d(x, D.mixed_kernel(
            q["kernel"], cfg.kernel_list, cfg.blur_kernel_size, deg.bank(d))),
        "median": lambda x, q, d: D.median_blur(
            torch.round(x * 255) / 255, ksize),
        "bilateral": lambda x, q, d: D.bilateral_blur(
            x, ksize, q["bilateral_sigma"], q["bilateral_sigma"]),
        "noise": lambda x, q, d: D.add_gaussian_noise(
            x[:, :64, :64], q["noise"]),
        "jpeg": lambda x, q, d: D.add_jpeg_compression(x, q["jpeg_quality"]),
        "down_up": lambda x, q, d: D.random_down_up(
            x, q["down_scale"], cfg.downsample_range)[0],
        "jitter": lambda x, q, d: D.color_jitter(x, q["jitter"]),
        "jitter_pt": lambda x, q, d: D.color_jitter_pt(x, q["jitter_pt"]),
        "chain": lambda x, q, d: torch.cat(deg.apply(x, q), dim=-1),
    }
    old = _tf32_off()
    out = {}
    try:
        for name, fn in stages.items():
            want = fn(gt, p, torch.device("cpu"))
            got = fn(gt.to(dev), pc, dev).cpu()
            d = (got - want).abs()
            row = dict(max_abs=float(d.max()),
                       within_2_levels=float((d <= 2 / 255 + 1e-6)
                                             .float().mean()))
            out[name] = row
            log(f"degradation {name:10s} card vs CPU: max|d| "
                f"{row['max_abs']:.3g}, share within 2/255 "
                f"{row['within_2_levels']:.6f}")
            if name == "median":
                # the 8-bit levels bit-equal (the card's division by 255 is
                # a multiply by its reciprocal: 1 ulp off the CPU's)
                require(torch.equal(torch.round(got * 255),
                                    torch.round(want * 255)),
                        "median: levels not bit-equal")
                require(row["max_abs"] <= 1e-7, "median: values")
            elif name in ("jpeg", "chain"):
                require(row["within_2_levels"] >= 0.99,
                        f"degradation {name}: card vs CPU")
            else:
                require(row["max_abs"] <= 1e-5, f"degradation {name}")
    finally:
        _tf32_restore(old)
    types = p["kernel"]["type_idx"].tolist()
    log(f"drawn kernel types {[cfg.kernel_list[t] for t in types]}")
    for bs in (4, 16):
        g16 = torch.Generator(dev).manual_seed(bs)
        x = torch.from_numpy(plate_batch(bs, 2400)).to(dev)
        arg_sets = [(deg.sample(g16, bs, 256, 256),) for _ in range(3)]
        ms = host_time_ms(lambda q: deg.apply(x, q), arg_sets, 10)
        out[f"apply_ms_bs{bs}"] = ms
        log(f"degradation apply bs={bs} 256²: {ms:.3f} ms per batch "
            "(host clock around CUDA events, sample half not timed)")
    return out


def phase_train_kernel_vs_plain(root):
    """Phase 24: one full-width G+D step and one R1 step with K1's kernel
    against the same with K1's plain version: same weights, batch, noise
    and degradation parameters, TF32 off; K1's launches per piece."""
    from image_restoration_tpu_torch.ops import fused_act
    model, _ = build_trainer(root)
    randomize_weights(model.net_g, seed=24)
    randomize_weights(model.net_d, seed=27)
    model.net_g_ema.load_state_dict(model.net_g.state_dict())
    gen = torch.Generator("cuda").manual_seed(24)
    gt = torch.from_numpy(plate_batch(4, 2410)).cuda()
    with torch.no_grad():
        lq, gtn = model.degrade_fn(gen, gt)
    noise = model.draw_noise(gen)
    old = _tf32_off()
    try:
        fused_act.fused_leaky_relu.launches = 0
        k = gan_pieces(model, lq, gtn, noise)
        torch.cuda.synchronize()
        launches = fused_act.fused_leaky_relu.launches
        want = K1_PER_GD_STEP + K1_PER_R1_STEP
        require(launches == want, f"K1 launched {launches} times in one G+D "
                f"and one R1 step, expected {want}")
        with mock.patch.object(fused_act, "fused_leaky_relu",
                               fused_act.fused_leaky_relu_plain):
            p = gan_pieces(model, lq, gtn, noise)
    finally:
        _tf32_restore(old)
    log("losses (K1): " + ", ".join(f"{k2} {v:.6g}" for k2, v in k[0].items()))
    require(all(math.isfinite(v) for v in k[0].values()), "non-finite loss")
    res = compare_pieces(k, p, "full-width step, K1 vs plain K1 (TF32 off)")
    log(f"K1 launches: {K1_PER_GD_STEP} per G+D step "
        f"({K1_LAUNCHES_PER_FORWARD} G + 3×{K1_PER_D_FORWARD} D), "
        f"{K1_PER_R1_STEP} per R1 step")
    del model
    torch.cuda.empty_cache()
    return dict(res, losses=k[0], k1_per_gd_step=K1_PER_GD_STEP,
                k1_per_r1_step=K1_PER_R1_STEP)


def tiny_train_opt(root):
    """The tiny config of tests/test_models.py:188-233 with the production
    losses (perceptual included)."""
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "model_type": "GFPGANModel", "name": "tiny",
            "path": {"models": f"{root}/tiny", "visualization": root},
            "network_g": dict(type="GFPGANv1OCR", input_width=32,
                              input_height=32, num_style_feat=16,
                              channel_multiplier=0.25, num_mlp=2,
                              input_is_latent=True, different_w=True,
                              narrow=0.5, sft_half=True),
            "network_d": dict(type="StyleGAN2Discriminator", input_width=32,
                              input_height=32, channel_multiplier=0.25,
                              narrow=0.25),
            "train": {"optim_g": {"type": "Adam", "lr": 2e-3},
                      "optim_d": {"type": "Adam", "lr": 2e-3},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
                      "L1_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "perceptual_opt": {
                          "type": "PerceptualLoss",
                          "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1,
                                            "conv3_4": 1, "conv4_4": 1,
                                            "conv5_4": 1},
                          "style_weight": 50, "range_norm": True},
                      "gan_opt": {"type": "GANLoss",
                                  "gan_type": "wgan_softplus",
                                  "loss_weight": 0.1},
                      "net_d_reg_every": 2, "r1_reg_weight": 10}}


def phase_train_tiny_card_vs_cpu(root):
    """Phase 25: the tiny config's G+D and R1 pieces on the card against
    the CPU at the same weights, batch and noise (TF32 off)."""
    from image_restoration_tpu_torch.models import build_model
    opt = tiny_train_opt(root)
    cpu = build_model(opt, device="cpu")
    card = build_model(opt, device="cuda")
    randomize_weights(cpu.net_g, seed=25)
    randomize_weights(cpu.net_d, seed=26)
    for name in ("net_g", "net_d"):
        getattr(card, name).load_state_dict(getattr(cpu, name).state_dict())
    card.cri_perceptual.vgg.load_state_dict(
        cpu.cri_perceptual.vgg.state_dict())
    g = torch.Generator().manual_seed(25)
    gt = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    lq = (gt + 0.2 * torch.randn(gt.shape, generator=g)).clamp(-1, 1)
    noise = [torch.randn(s, generator=g)
             for s in cpu.net_g.stylegan_decoder.noise_shapes()]
    want = gan_pieces(cpu, lq, gt, noise)
    old = _tf32_off()
    try:
        got = gan_pieces(card, lq.cuda(), gt.cuda(), [n.cuda() for n in noise])
    finally:
        _tf32_restore(old)
    return compare_pieces(got, want, "tiny config, card vs CPU (TF32 off)")


def phase_train_main_path(root):
    """Phase 26, the main path: counts at 0, then
    `train_pipeline` on configs/train_gfpgan_plate_256.yml with
    --force_yml (synthetic plates, 32 iterations, R1 at 16 and 32,
    validation and a checkpoint at 32), counts read; every loss finite; the
    saved EMA G served by Restorer(ckpt_path=...) and one POST /Restore/."""
    import cv2
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
    from image_restoration_tpu_torch.train import train_pipeline
    from image_restoration_tpu_torch.utils.img_util import tensor2img
    write_plates(f"{root}/train", 8, 2600)
    write_plates(f"{root}/val", TRAIN_VAL_IMAGES, 2700)
    argv = train_options(root)
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = (k.launches for k in kernels)
    val_forwards = 2 * TRAIN_VAL_IMAGES   # at 32 and after the last step
    want = (TRAIN_ITERS * K1_PER_GD_STEP
            + (TRAIN_ITERS // 16) * K1_PER_R1_STEP
            + val_forwards * K1_LAUNCHES_PER_FORWARD)
    log(f"train_pipeline: {TRAIN_ITERS} iterations in {wall:.2f} s (wall, "
        f"build, validation and saves included); K1 {k1} launches "
        f"(expected {want}), K2 {k2}, K3 {k3}; last losses "
        + ", ".join(f"{k}={v:.4g}" for k, v in model.log_dict.items()))
    require(k1 == want, f"train main path: K1 launched {k1}, expected {want}")
    require(k2 == 0 and k3 == 0, "train main path launched K2 or K3")
    require(model.iter == TRAIN_ITERS, f"model.iter {model.iter}")
    require("l_d_r1" in model.log_dict, "R1 did not run at the last step")
    require(all(math.isfinite(v) for v in model.log_dict.values()),
            "a non-finite loss")
    mdir = model.opt["path"]["models"]
    ckpt = os.path.join(mdir, f"net_g_{TRAIN_ITERS}.pth")
    require(os.path.exists(ckpt) and os.path.exists(
        os.path.join(mdir, f"ckpt_{TRAIN_ITERS}.pth")), "no checkpoint")
    val = model.validation(_val_loader(model.opt), TRAIN_ITERS)
    log(f"validation PSNR of the EMA G (random init, 32 steps): {val}")

    restorer = Restorer(PRODUCTION_GFPGAN, ckpt_path=ckpt, device="cuda")
    x = plate_batch(2, 2800)
    got = restorer.restore_batch(x)
    want_out = model.test(torch.from_numpy((x - 0.5) / 0.5)).float().cpu()
    ref = np.stack([tensor2img(want_out[i:i + 1].numpy(), min_max=(-1, 1))
                    for i in range(2)])
    lsb = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
    log(f"Restorer(ckpt_path=net_g_{TRAIN_ITERS}.pth) vs the trained EMA G: "
        f"max {lsb} LSB")
    require(lsb <= 1, f"checkpoint restore: {lsb} LSB")
    core = ServiceCore(restorer)
    server = make_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ok, buf = cv2.imencode(".jpg", plate_image(120, 360, seed=2900))
        status, media, body = post(server.server_address[1], "/Restore/",
                                   buf.tobytes())
        img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        require(status == 200 and img is not None
                and img.shape == (256, 256, 3),
                f"/Restore/ with the trained checkpoint: {status}")
        log(f"POST /Restore/ with the trained checkpoint -> {status} "
            f"{img.shape}")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    return model, dict(k1=k1, k1_expected=want, wall_s=wall,
                       last_losses=model.log_dict, val=val)


def _val_loader(opt):
    from image_restoration_tpu_torch.data import (build_dataloader,
                                                  build_dataset)
    ds = opt["datasets"]["val"]
    return build_dataloader(build_dataset(ds), ds)


def timed_steps(model, bs, iters, seed):
    """Seconds of each of `iters` optimize_parameters calls as a training
    loop runs them: no synchronize between steps (the step waits for
    nothing), a CUDA event after each, all read after the last; on batches
    from a pool of synthetic plates. Also the host clock's mean s per step
    from the call of step 5 to a synchronize after the last."""
    pool = plate_batch(2 * bs, seed)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for it in range(1, iters + 1):
        if it == 5:
            t0 = time.perf_counter()
        model.optimize_parameters(
            it, {"gt": pool[(it % 2) * bs:(it % 2 + 1) * bs]})
        events[it].record()
    torch.cuda.synchronize()
    host_mean = (time.perf_counter() - t0) / (iters - 4)
    return ([e0.elapsed_time(e1) / 1e3 for e0, e1 in zip(events, events[1:])],
            host_mean)


def phase_train_throughput(root, model4):
    """Phase 27: s per step (median of steps 5-16 as `timed_steps` runs
    them, the R1 step 16 included in the run), trained imgs/s, the
    R1 step's ms, peak MiB and achieved TFLOP/s against
    analytic_gfpgan_flops, at bs 4 (TRAIN_SPEED_BATCHES), with PyTorch's default TF32
    settings."""
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rows = {}
    for bs in TRAIN_SPEED_BATCHES:
        model = model4 if bs == 4 else build_trainer(root, bs)[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, host_mean = timed_steps(model, bs, TIMED_STEPS, 3000 + bs)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        step = float(np.median(times[4:]))
        gt = torch.from_numpy(plate_batch(bs, 3100)).cuda() * 2 - 1

        def r1_step():
            model.optimizer_d.zero_grad()
            model.r1_loss(gt).backward()
            model.optimizer_d.step()

        r1_ms = host_time_ms(r1_step, [()], 5)
        flops = analytic_gfpgan_flops(bs)
        rows[bs] = dict(s_per_step=step, host_s_per_step=host_mean,
                        steps_per_s=1 / step,
                        imgs_per_s=bs / step, r1_step_ms=r1_ms,
                        peak_mib=peak, tflops=flops / step / 1e12,
                        step_16_s=times[15])
        log(f"GAN step bs={bs}: {step * 1e3:.2f} ms/step (median of steps "
            f"5-{TIMED_STEPS}), host clock {host_mean * 1e3:.2f} ms/step "
            f"(mean of 5-{TIMED_STEPS}), {1 / step:.3f} steps/s, "
            f"{bs / step:.2f} imgs/s, "
            f"R1 step {r1_ms:.2f} ms, step 16 (with R1) "
            f"{times[15] * 1e3:.1f} ms, peak "
            f"{peak:.0f} MiB, {flops / step / 1e12:.2f} TFLOP/s against "
            "analytic_gfpgan_flops")
        if bs != 4:
            del model
            torch.cuda.empty_cache()
    return rows


def phase_train_profile(model, step_ms):
    """Phase 28: where one bs-4 G+D step's device time goes, all on
    `optimize_parameters` itself. CUDA events at its parts' boundaries
    (the model's `mark` hook; one run, synchronized before, so the parts
    show the device timeline of the step run alone); a profiler trace of
    another run for the device-busy share (of the profiled step's wall
    time, and of phase 27's s per step, `step_ms`), the host's waits on
    the device (and, from a run in sync debug mode, the lines of the ops
    that synchronize), the FIR depthwise convs, K1's forward launches, K1's
    PyTorch-op backward (its function wrapped in a profiler range for this
    run) and the VGG forward (likewise); VGG forward + backward and D
    forward + backward timed alone at the step's shapes."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from image_restoration_tpu_torch.ops import fused_act
    batch = {"gt": plate_batch(4, 3200)}
    it = 5
    model.optimize_parameters(it, batch)
    torch.cuda.synchronize()

    events = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    model.mark = mark
    try:
        model.optimize_parameters(it, batch)
    finally:
        model.mark = None
    torch.cuda.synchronize()
    seg = {name: e0.elapsed_time(e1)
           for (name, e0), (_, e1) in zip(events, events[1:])}
    seg_ms = sum(seg.values())

    # where the step makes the host wait: PyTorch warns at each op that
    # synchronizes, from the Python line that called it
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.optimize_parameters(it, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sync_sites = [f"{os.path.relpath(w.filename)}:{w.lineno}"
                  for w in caught
                  if "called a synchronizing" in str(w.message)]

    def ranged(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    vgg = model.cri_perceptual.vgg
    patches = [mock.patch.object(fused_act, "fused_leaky_relu_backward",
                                 ranged("irt.k1_backward",
                                        fused_act.fused_leaky_relu_backward)),
               mock.patch.object(vgg, "forward",
                                 ranged("irt.vgg_forward", vgg.forward))]
    for p in patches:
        p.start()
    try:
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.optimize_parameters(it, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # drop the ranges, which also appear on the device's timeline
            kernels = [k for k in _kernel_events(prof)
                       if not k[2].startswith(("irt.", "Optimizer."))]
            k1_n = sum(k[1] for k in kernels if "fused_bias_lrelu" in k[2])
            if k1_n == K1_PER_GD_STEP:
                break
            log(f"profiler saw {k1_n} K1 launches: profiling again")
    finally:
        for p in patches:
            p.stop()
    require(k1_n == K1_PER_GD_STEP, f"step profile: {k1_n} K1 launches")
    busy = sum(k[0] for k in kernels)

    def op_ms(key):
        return sum(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)) / 1e3
                   for e in prof.key_averages()
                   if e.key == key and getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU)

    # the host's waits on the device inside the step: the profile's counts
    # less those of a profile of the closing synchronize alone
    def sync_calls(p):
        return {e.key: e.count for e in p.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaEventSynchronize",
                             "cudaDeviceSynchronize")}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as empty:
        torch.cuda.synchronize()
    base = sync_calls(empty)
    waits = {k: v - base.get(k, 0) for k, v in sync_calls(prof).items()}
    # cuDNN's grouped direct conv is the FIR forward, its c1/k1 dgrad the
    # FIR backward (the depthwise convs' kernels in the restore's profiles)
    parts = {"fir_depthwise": sum(k[0] for k in kernels if any(
        key in k[2] for key in FIR_KERNEL_KEYS)),
             "k1_forward": sum(k[0] for k in kernels
                               if "fused_bias_lrelu" in k[2]),
             "k1_backward_ops": op_ms("irt.k1_backward"),
             "vgg_forward": op_ms("irt.vgg_forward")}
    # VGG and D forward + backward alone, at the step's shapes
    x = (torch.rand((4, 256, 256, 3), device="cuda") * 2 - 1)
    xg = x.clone().requires_grad_(True)

    def vgg_fb():
        p, s = model.cri_perceptual(xg, x)
        (p + s).backward()

    def d_fb():
        model.d_loss(xg, x)[0].backward()

    alone = {"vgg_fwd_bwd": host_time_ms(vgg_fb, [()], 5),
             "d_fwd_bwd_fake_real": host_time_ms(d_fb, [()], 5)}
    model.net_d.zero_grad(set_to_none=True)
    log(f"profile of optimize_parameters bs=4: wall {wall:.2f} ms under the "
        f"profiler, device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of "
        f"that wall; {100 * busy / step_ms:.1f}% of phase 27's "
        f"{step_ms:.2f} ms per step); host waits on the device in the step: "
        f"{waits}; ops that synchronize (sync debug mode): "
        f"{len(sync_sites)}")
    for site in sync_sites:
        log(f"    {site}")
    log(f"  parts of the step alone (CUDA events at the model's marks): "
        f"{seg_ms:.2f} ms")
    for name, ms in seg.items():
        log(f"  {name:25s} {ms:9.3f} ms  {100 * ms / seg_ms:5.1f}%")
    for name, ms in parts.items():
        log(f"  {name:25s} {ms:9.3f} ms  {100 * ms / busy:5.1f}% of busy")
    for name, ms in alone.items():
        log(f"  alone: {name:20s} {ms:9.3f} ms")
    for t, n, name in kernels[:15]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    return dict(segments_ms=seg, segments_total_ms=seg_ms,
                step_ms=step_ms, wall_ms=wall,
                busy_ms=busy, busy_share_of_wall=busy / wall,
                busy_share_of_step=busy / step_ms, host_waits=waits,
                sync_sites=sync_sites,
                parts_ms=parts,
                parts_share={k: v / busy for k, v in parts.items()},
                alone_ms=alone,
                top=[dict(ms=t, count=n, name=name[:200])
                     for t, n, name in kernels[:25]])


def phase_train(tmp):
    """Path 6: phases 23-28."""
    deg = phase_train_degradation(tmp)
    step = phase_train_kernel_vs_plain(tmp)
    tiny = phase_train_tiny_card_vs_cpu(tmp)
    model, main_path = phase_train_main_path(tmp)
    thr = phase_train_throughput(tmp, model)
    prof = phase_train_profile(model, thr[4]["s_per_step"] * 1e3)
    del model
    torch.cuda.empty_cache()
    return main_path["k1"], dict(degradation=deg, kernel_vs_plain=step,
                                 tiny_card_vs_cpu=tiny, main_path=main_path,
                                 throughput=thr, profile=prof)


# ------------------------------------------- path 7: the SR trainers

QAT_CONFIG = "configs/train_qat_srvgg_x4.yml"
DISTILL_CONFIG = "configs/train_distill_rrdb_to_srvgg.yml"
ESRGAN_CONFIG = "configs/train_esrgan_x4.yml"
ESRGAN_TEST_CONFIG = "configs/test_esrgan_x4.yml"
QAT_ITERS = 32
SR_TRAIN_ITERS = 16                 # distill and ESRGAN
SR_BS = 16      # every SR config's batch_size_per_gpu, and the GT images
                # of a GT-only set (enlarge ratio 1: one batch an epoch)
QAT_GATE_DB = 35.0                  # tests/test_qat.py:30-52
SR_STATS_TOL = 1e-5                 # D's refreshed running stats, card/CPU
SR_TINY_G = dict(type="SRVGGNetCompact", num_feat=8, num_conv=2, upscale=4)
SR_TINY_RRDB = dict(type="RRDBNet", num_feat=8, num_block=1, num_grow_ch=4,
                    scale=4)


def write_scenes(folder, n, seed, h, w):
    import cv2
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"scene_{i:03d}.png"),
                    scene_image(h, w, seed + i)[..., ::-1])


def write_pairs(root, n, seed, size):
    """GT scenes of size², each with its LQ made by an area ×1/4 resize."""
    import cv2
    for d in ("gt", "lq"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        gt = np.ascontiguousarray(scene_image(size, size, seed + i)[..., ::-1])
        cv2.imwrite(os.path.join(root, "gt", f"img_{i:03d}.png"), gt)
        cv2.imwrite(os.path.join(root, "lq", f"img_{i:03d}.png"), cv2.resize(
            gt, (size // 4, size // 4), interpolation=cv2.INTER_AREA))


def scene_batch(n, seed, size=256):
    """(n, size, size, 3) RGB float [0, 1] synthetic scenes."""
    return np.stack([scene_image(size, size, seed + i) for i in range(n)]
                    ).astype(np.float32) / 255.0


def phase_sr_degradation():
    """Phase 29: the Real-ESRGAN chain's apply half on the card against the
    CPU at one set of drawn parameters (bs 16, 256²), stage by stage, each
    stage on the same CPU input (the Poisson counts drawn on the CPU and
    replayed); then the whole chain, and its ms per batch."""
    from image_restoration_tpu_torch.data import degradations as D
    from image_restoration_tpu_torch.data.pipelines import (
        RealESRGANDegradationConfig, make_realesrgan_degradation,
        virtual_rescale)
    cfg = RealESRGANDegradationConfig()
    deg = make_realesrgan_degradation(cfg)
    dev = torch.device("cuda")
    gt = torch.from_numpy(scene_batch(SR_BS, 2900))
    p = deg.sample(torch.Generator().manual_seed(29), SR_BS, 256, 256)
    cpu_gen = torch.Generator().manual_seed(30)
    stages = [
        ("blur 1", lambda x, q: deg.blur_stage(x, q["blur1"],
                                               cfg.kernel_list)),
        ("rescale 1", lambda x, q: virtual_rescale(x, q["resize1"])),
        ("noise 1", lambda x, q: deg.noise_stage(x, q["noise1"], cpu_gen)),
        ("jpeg 1", lambda x, q: D.add_jpeg_compression(x, q["jpeg1"])),
        ("blur 2", lambda x, q: deg.blur_stage(x, q["blur2"],
                                               cfg.kernel_list2)),
        ("rescale 2", lambda x, q: virtual_rescale(x, q["resize2"])),
        ("noise 2", lambda x, q: deg.noise_stage(x, q["noise2"], cpu_gen)),
        ("final", lambda x, q: deg.final_stage(x, q)),
    ]
    old = _tf32_off()
    out = {}
    try:
        x = gt
        for name, fn in stages:
            want = fn(x, p)   # on the CPU first: it draws the Poisson counts
            got = fn(x.to(dev), D.params_to(p, dev)).cpu()
            d = (got - want).abs()
            row = dict(max_abs=float(d.max()),
                       within_2_levels=float((d <= 2 / 255 + 1e-6)
                                             .float().mean()))
            out[name] = row
            log(f"Real-ESRGAN {name:9s} card vs CPU: max|d| "
                f"{row['max_abs']:.3g}, share within 2/255 "
                f"{row['within_2_levels']:.6f}")
            if name in ("jpeg 1", "final"):
                require(row["within_2_levels"] >= 0.99,
                        f"Real-ESRGAN {name}: card vs CPU")
            else:
                require(row["max_abs"] <= 1e-5, f"Real-ESRGAN {name}")
            x = want
        want, _ = deg.apply(gt, p)
        got, gt_out = deg.apply(gt.to(dev), D.params_to(p, dev))
        d = (got.cpu() - want).abs()
        row = dict(max_abs=float(d.max()),
                   within_2_levels=float((d <= 2 / 255 + 1e-6)
                                         .float().mean()))
        out["chain"] = row
        log(f"Real-ESRGAN chain     card vs CPU: max|d| {row['max_abs']:.3g}"
            f", share within 2/255 {row['within_2_levels']:.6f}; lq "
            f"{tuple(got.shape)}")
        require(row["within_2_levels"] >= 0.99 and got.shape ==
                (SR_BS, 64, 64, 3) and torch.equal(gt_out.cpu(), gt),
                "Real-ESRGAN chain: card vs CPU")
    finally:
        _tf32_restore(old)
    g = torch.Generator(dev).manual_seed(31)
    x = gt.to(dev)
    out["ms_bs16"] = host_time_ms(lambda: deg(g, x), [()], 10)
    log(f"Real-ESRGAN chain bs={SR_BS} 256² on the card: "
        f"{out['ms_bs16']:.3f} ms per batch (sample and apply)")
    return out


def sr_tiny_opt(root, kind):
    """The CPU tests' tiny config of each trainer (bs 2–4, TF32 off)."""
    train = {"optim_g": {"type": "Adam", "lr": 1e-3},
             "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
             "ema_decay": 0.9}
    opt = {"is_train": True, "manual_seed": 0, "num_devices": 1,
           "scale": 4, "name": f"tiny_{kind}",
           "path": {"models": f"{root}/tiny_{kind}", "visualization": root},
           "network_g": dict(SR_TINY_G), "train": train}
    if kind == "qat":
        opt["model_type"] = "SRModel"
        train["quant_opt"] = {"ema_decay": 0.99}
    elif kind == "distill":
        opt["model_type"] = "DistillModel"
        opt["network_t"] = dict(SR_TINY_RRDB)
        train.update(distill_opt={"type": "L1Loss", "loss_weight": 1.0},
                     allow_random_teacher=True)
    else:
        opt["model_type"] = "ESRGANModel"
        opt["network_g"] = dict(SR_TINY_RRDB)
        opt["network_d"] = {"type": "VGGStyleDiscriminator128",
                            "num_in_ch": 3, "num_feat": 4}
        train.update(
            optim_d={"type": "Adam", "lr": 1e-3},
            perceptual_opt={"type": "PerceptualLoss",
                            "layer_weights": {"conv1_2": 1},
                            "range_norm": False, "style_weight": 0},
            gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                     "loss_weight": 5e-3})
    return opt


def sr_pieces(model, lq, gt, out_d=None):
    """Losses and gradients of one SR step, pieces only (no update): G's
    loss terms and G's gradients; under QAT the batch maxima that move the
    scales; for a GAN trainer D's losses and gradients at `out_d` (the
    same detached output on both devices) and D's running statistics
    refreshed from it."""
    model.net_g.zero_grad(set_to_none=True)
    if hasattr(model, "net_d"):
        model.net_d.requires_grad_(False)
    total, losses, out, batch_max = model.g_losses(lq, gt)
    total.backward()
    grads = dict(g=_grads(model.net_g))
    losses = {k: float(v.detach()) for k, v in losses.items()}
    if batch_max is not None:
        losses.update({f"max_{i}": float(v) for i, v in
                       enumerate(batch_max.tolist())})
    stats = None
    if hasattr(model, "net_d"):
        model.net_d.requires_grad_(True)
        model.net_d.zero_grad(set_to_none=True)
        l_d, parts = model._gan_d_losses(out_d, gt)
        l_d.backward()
        grads["d"] = _grads(model.net_d)
        losses.update({k: float(v.detach()) for k, v in parts.items()},
                      l_d=float(l_d.detach()))
        model.net_d.zero_grad(set_to_none=True)
        model._refresh_d_stats(out_d, gt)
        stats = {k: v.detach().cpu() for k, v in
                 model.net_d.state_dict().items() if "running" in k}
    model.net_g.zero_grad(set_to_none=True)
    return (losses, out.detach(), grads), stats


def phase_sr_tiny_card_vs_cpu(root):
    """Phase 30: each SR trainer's tiny step pieces on the card against the
    CPU at the same weights and batch (TF32 off): losses within 1e-5
    relative, gradients within 1e-4 of max|grad|, D's refreshed running
    statistics within 1e-5."""
    from image_restoration_tpu_torch.models import build_model
    res = {}
    old = _tf32_off()
    try:
        for kind in ("qat", "distill", "esrgan"):
            opt = sr_tiny_opt(root, kind)
            cpu = build_model(opt, device="cpu")
            card = build_model(opt, device="cuda")
            nets = ["net_g"] + [n for n in ("net_t", "net_d")
                                if hasattr(cpu, n)]
            for i, name in enumerate(nets):
                randomize_weights(getattr(cpu, name), seed=300 + i)
                getattr(card, name).load_state_dict(
                    getattr(cpu, name).state_dict())
            if kind == "esrgan":
                card.cri_perceptual.vgg.load_state_dict(
                    cpu.cri_perceptual.vgg.state_dict())
            n, hw = (4, 32) if kind == "esrgan" else (2, 16)
            g = torch.Generator().manual_seed(30)
            lq = torch.rand((n, hw, hw, 3), generator=g)
            gt = torch.rand((n, 4 * hw, 4 * hw, 3), generator=g)
            out_d = torch.rand(gt.shape, generator=g)
            want, ws = sr_pieces(cpu, lq, gt, out_d)
            got, gs = sr_pieces(card, lq.cuda(), gt.cuda(), out_d.cuda())
            row = compare_pieces(got, want, f"SR tiny {kind}, card vs CPU "
                                 "(TF32 off)")
            if ws is not None:
                worst = max(float((gs[k] - v).abs().max())
                            for k, v in ws.items())
                log(f"SR tiny {kind}: D's refreshed running stats card vs "
                    f"CPU max|d| {worst:.3g}")
                require(worst <= SR_STATS_TOL, f"{kind}: D stats {worst}")
                row["d_stats_abs"] = worst
            res[kind] = row
    finally:
        _tf32_restore(old)
    return res


def timed_sr_steps(model, batches, iters):
    """s per step of `iters` optimize_parameters calls as a training loop
    runs them (CUDA events, no synchronize between steps), cycling through
    `batches`; and the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for it in range(1, iters + 1):
        model.optimize_parameters(model.iter + 1,
                                  batches[it % len(batches)])
        events[it].record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    return times, torch.cuda.max_memory_allocated() / 2 ** 20


def step_busy(model, batch):
    """(wall ms, device-busy ms) of one profiled step."""
    model.optimize_parameters(model.iter + 1, batch)
    wall, kernels, _ = profile_call(
        lambda: model.optimize_parameters(model.iter + 1, batch),
        "no kernel has this name", 0)
    return wall, sum(k[0] for k in kernels)


def sr_step_rates(name, model, batches, iters):
    """Phase rows: s per step (median after the first 4), imgs/s, peak MiB
    and the device-busy share of one profiled step."""
    times, peak = timed_sr_steps(model, batches, iters)
    step = float(np.median(times[4:]))
    wall, busy = step_busy(model, batches[0])
    row = dict(s_per_step=step, imgs_per_s=SR_BS / step, peak_mib=peak,
               profiled_step_ms=wall, busy_ms=busy,
               busy_share=busy / wall)
    log(f"{name} bs={SR_BS}: {step * 1e3:.2f} ms/step (median of steps "
        f"5-{iters}), {SR_BS / step:.2f} imgs/s, peak {peak:.0f} MiB; a "
        f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%)")
    return row


def sr_train(root, argv, what):
    """`train_pipeline` with the counts at 0; no kernel of the port runs on
    the SR trainers' paths (SRVGG's PReLU, RRDBNet's and the VGG-style D's
    LeakyReLU are plain ops). Returns (model, wall s)."""
    from image_restoration_tpu_torch.train import train_pipeline
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    log(f"{what}: {model.iter} iterations in {wall:.2f} s (wall: build, "
        f"validation and saves included); K1/K2/K3 launches {counts}; last "
        "losses " + ", ".join(f"{k}={v:.4g}"
                              for k, v in model.log_dict.items()))
    require(counts == [0, 0, 0], f"{what}: a port kernel launched {counts}")
    require(all(math.isfinite(v) for v in model.log_dict.values()),
            f"{what}: a non-finite loss")
    return model, wall


def phase_qat(root):
    """Phase 31, QAT: train_pipeline on configs/train_qat_srvgg_x4.yml as
    written (SRVGG 64×32, gt 256, bs 16, the Real-ESRGAN chain on the card)
    for 32 steps; its ckpt_32.pth built into the int8 engine (tile 512,
    halo 8, 8 tiles per call, pack 2, uint8 IO), served with the counts at
    0 (K2 34 per engine call) through EngineRestorer and POST /SRx4/; the
    engine bit-equal to the same chain on K2's plain version, and ≥ 35 dB
    against qat_srvgg_forward at the exported scales; s/step, imgs/s,
    busy share, peak MiB and tiles/s."""
    import cv2
    from image_restoration_tpu_torch.ops import quantized_inference as qi
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant_plain)
    from image_restoration_tpu_torch.ops.qat import qat_srvgg_forward
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
    from image_restoration_tpu_torch.serve.engine_restorer import (
        EngineRestorer)
    from image_restoration_tpu_torch.serve.sr_engine import (
        build_srvgg, load_qat_checkpoint)
    write_scenes(f"{root}/gt", SR_BS, 3100, 320, 320)
    write_scenes(f"{root}/val", 2, 3200, 256, 256)
    model, wall = sr_train(root, [
        "-opt", QAT_CONFIG, "--force_yml",
        f"datasets:train:dataroot_gt={root}/gt",
        f"datasets:val:dataroot_gt={root}/val", "path:pretrain_network_g=~",
        f"train:total_iter={QAT_ITERS}", f"val:val_freq={QAT_ITERS}",
        f"logger:save_checkpoint_freq={QAT_ITERS}", "logger:print_freq=8"],
        "QAT train_pipeline")
    require(model.iter == QAT_ITERS and bool((model.qscale > 0).all()),
            "QAT: scales not trained")
    log("QAT scales: " + " ".join(f"{v:.4g}" for v in model.qscale.tolist()))
    ckpt = os.path.join(model.opt["path"]["models"], f"ckpt_{QAT_ITERS}.pth")
    res = dict(train_wall_s=wall, last_losses=model.log_dict)

    engine = EngineRestorer.build(qat_ckpt=ckpt, seed=0, device="cuda", **SR)
    require(engine.meta["qat"], "engine meta: not a QAT engine")

    def chunks(h, w):
        return math.ceil(math.ceil(h / SR["tile"]) * math.ceil(w / SR["tile"])
                         / SR["batch"])

    kernels = _counts_zero()
    img = scene_image(768, 1024, seed=3300)
    out = engine(img)
    require(out.shape == (3072, 4096, 3) and out.dtype == np.uint8,
            f"QAT engine: {out.shape}")
    core = ServiceCore(sr_engine=engine)
    server = make_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bgr = np.ascontiguousarray(scene_image(360, 640, seed=3301)[..., ::-1])
        ok, buf = cv2.imencode(".png", bgr)
        status, media, body = post(server.server_address[1], "/SRx4/",
                                   buf.tobytes())
        got = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        require(status == 200 and got is not None
                and got.shape == (1440, 2560, 3), f"/SRx4/: {status}")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    k1, k2, k3 = (k.launches for k in kernels)
    want = K2_LAUNCHES_PER_CALL * (chunks(768, 1024) + chunks(360, 640))
    log(f"QAT engine main path: EngineRestorer 1024x768 and POST /SRx4/ "
        f"640x360 -> K2 {k2} launches (expected {want}, "
        f"{K2_LAUNCHES_PER_CALL} per engine call), K1 {k1}, K3 {k3}")
    require(k2 == want and k1 == 0 and k3 == 0, "QAT engine: launch counts")
    res.update(k2=k2, k2_expected=want)

    s = SR["tile"] + 2 * SR["halo"]
    big = scene_image(2 * s, 4 * s, seed=3302)
    x = torch.from_numpy(np.stack([big[i * s:(i + 1) * s, j * s:(j + 1) * s]
                                   for i in range(2) for j in range(4)])
                         ).cuda()
    with torch.inference_mode():
        got = engine.serve(x)
        with mock.patch.object(qi, "int8_conv3x3_requant",
                               int8_conv3x3_requant_plain):
            plain = engine.serve(x)
    torch.cuda.synchronize()
    require(torch.equal(got, plain), "QAT engine: K2 vs plain K2 differ")
    log(f"QAT engine on K2 vs on plain K2 (8 tiles of {s}², uint8 IO): "
        "bit-equal")
    sd, scales = load_qat_checkpoint(ckpt, SR["num_feat"], SR["num_conv"],
                                     SR["upscale"])
    net = build_srvgg(SR["num_feat"], SR["num_conv"], SR["upscale"],
                      device="cpu")
    net.load_state_dict(sd)
    net = net.cuda()
    old = _tf32_off()
    try:
        with torch.inference_mode():
            xb = x.to(torch.bfloat16) / 255.0
            q = qi.quantize_srvgg_params(net, scales, pack=2)
            served = qi.quantized_srvgg_forward(q, xb, SR["num_conv"],
                                                SR["upscale"], pack=2)
            fake, _ = qat_srvgg_forward(net, xb.float(),
                                        torch.tensor(scales, device="cuda"))
    finally:
        _tf32_restore(old)
    db = span_psnr(fake, served)
    log(f"QAT engine (int8, K2) vs qat_srvgg_forward at the exported scales: "
        f"span-normalized PSNR {db:.2f} dB (gate >= {QAT_GATE_DB})")
    require(db >= QAT_GATE_DB, f"QAT engine vs fake-quant: {db:.2f} dB")
    res["engine_vs_fake_quant_db"] = db
    del fake, served, xb, q

    batches = [{"gt": scene_batch(SR_BS, 3400 + 20 * i)} for i in range(2)]
    res["steps"] = sr_step_rates("QAT step", model, batches, TIMED_STEPS)
    med, lo, hi = median_ms(lambda: engine.serve(x), 10)
    res.update(engine_ms_per_call=med,
               engine_tiles_per_s=SR["batch"] / med * 1e3)
    log(f"QAT engine: {med:.3f} ms per call of {SR['batch']} tiles (min "
        f"{lo:.3f}, max {hi:.3f}) = {res['engine_tiles_per_s']:.2f} tiles/s")
    del engine, model
    torch.cuda.empty_cache()
    return k2, res


def phase_distill(root):
    """Phase 32, distillation: train_pipeline on
    configs/train_distill_rrdb_to_srvgg.yml with a bf16 RRDBNet-23 teacher
    from a seeded .pth, 16 steps; the teacher bit-unchanged; s/step."""
    from image_restoration_tpu_torch.archs import build_network
    write_scenes(f"{root}/gt", SR_BS, 3500, 320, 320)
    write_scenes(f"{root}/val", 2, 3600, 256, 256)
    teacher = build_network(dict(type="RRDBNet", num_feat=64, num_block=23,
                                 scale=4), torch.Generator().manual_seed(32))
    randomize_weights(teacher, seed=33)
    t_sd = {k: v.clone() for k, v in teacher.state_dict().items()}
    torch.save({"params_ema": t_sd}, f"{root}/teacher.pth")
    model, wall = sr_train(root, [
        "-opt", DISTILL_CONFIG, "--force_yml",
        f"datasets:train:dataroot_gt={root}/gt",
        f"datasets:val:dataroot_gt={root}/val",
        f"path:pretrain_network_t={root}/teacher.pth",
        f"train:total_iter={SR_TRAIN_ITERS}",
        f"val:val_freq={SR_TRAIN_ITERS}",
        f"logger:save_checkpoint_freq={SR_TRAIN_ITERS}",
        "logger:print_freq=8"], "distill train_pipeline")
    require(model.net_t.dtype == torch.bfloat16, "teacher not bf16")
    changed = [k for k, v in model.net_t.state_dict().items()
               if not torch.equal(v.cpu(), t_sd[k])]
    log(f"distill: teacher parameters after {model.iter} steps: "
        f"{len(changed)} of {len(t_sd)} tensors changed (must be 0)")
    require(not changed and model.iter == SR_TRAIN_ITERS,
            f"distill: teacher changed {changed[:3]}")
    batches = [{"gt": scene_batch(SR_BS, 3700 + 20 * i)} for i in range(2)]
    res = dict(train_wall_s=wall, last_losses=model.log_dict)
    res["steps"] = sr_step_rates("distill step", model, batches,
                                 SR_TRAIN_ITERS)
    del model
    torch.cuda.empty_cache()
    return res


def phase_esrgan(root):
    """Phase 33, ESRGAN ×4: train_pipeline on configs/train_esrgan_x4.yml
    (RRDBNet-23, gt 128, bs 16, VGGStyleDiscriminator128, conv5_4
    perceptual, vanilla GAN) on seeded GT with area ×1/4 LQ, 16 steps;
    then test.py with configs/test_esrgan_x4.yml on the run's
    net_g_16.pth; s/step, imgs/s, busy share, PSNR/SSIM."""
    import cv2
    from image_restoration_tpu_torch.test import test_pipeline
    write_pairs(f"{root}/train", 8, 3800, 160)
    write_pairs(f"{root}/val", 2, 3900, 128)
    model, wall = sr_train(root, [
        "-opt", ESRGAN_CONFIG, "--force_yml",
        f"datasets:train:dataroot_gt={root}/train/gt",
        f"datasets:train:dataroot_lq={root}/train/lq",
        f"datasets:val:dataroot_gt={root}/val/gt",
        f"datasets:val:dataroot_lq={root}/val/lq",
        f"train:total_iter={SR_TRAIN_ITERS}",
        f"val:val_freq={SR_TRAIN_ITERS}",
        f"logger:save_checkpoint_freq={SR_TRAIN_ITERS}",
        "logger:print_freq=8"], "ESRGAN train_pipeline")
    require(model.iter == SR_TRAIN_ITERS and "l_g_gan" in model.log_dict,
            "ESRGAN: the G step did not run")
    ckpt = os.path.join(model.opt["path"]["models"],
                        f"net_g_{SR_TRAIN_ITERS}.pth")
    res = dict(train_wall_s=wall, last_losses=model.log_dict)
    batches = []
    for i in range(2):
        gt = scene_batch(SR_BS, 4000 + 20 * i, 128)
        lq = np.stack([cv2.resize(g, (32, 32), interpolation=cv2.INTER_AREA)
                       for g in gt])
        batches.append({"lq": lq, "gt": gt})
    res["steps"] = sr_step_rates("ESRGAN step", model, batches,
                                 SR_TRAIN_ITERS)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    metrics = test_pipeline(root, argv=[
        "-opt", ESRGAN_TEST_CONFIG, "--force_yml",
        f"datasets:test_1:dataroot_gt={root}/val/gt",
        f"datasets:test_1:dataroot_lq={root}/val/lq",
        f"path:pretrain_network_g={ckpt}"])
    res["test_py"] = dict(metrics=metrics, wall_s=time.perf_counter() - t0)
    log(f"test.py on net_g_{SR_TRAIN_ITERS}.pth (Set14 folder: 2 synthetic "
        f"pairs): {metrics} in {res['test_py']['wall_s']:.2f} s; random "
        "weights, random VGG taps and synthetic data: not a quality number")
    m = metrics.get("Set14", {})
    require(math.isfinite(m.get("psnr", float("nan")))
            and -1 <= m.get("ssim", 2) <= 1, "test.py metrics")
    return res


def phase_sr_train(tmp):
    """Path 7: phases 29-33."""
    deg = phase_sr_degradation()
    tiny = phase_sr_tiny_card_vs_cpu(tmp)
    qat_k2, qat = phase_qat(os.path.join(tmp, "qat"))
    distill = phase_distill(os.path.join(tmp, "distill"))
    esrgan = phase_esrgan(os.path.join(tmp, "esrgan"))
    return qat_k2, dict(degradation=deg, tiny_card_vs_cpu=tiny, qat=qat,
                        distill=distill, esrgan=esrgan)


# ------------------------------------- path 8: the StyleGAN2 family

SG2_CONFIG = "configs/options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml"
SG2_ITERS = 32               # R1 at 16 and 32, the path step every 4
SG2_IMAGES = 16
SG2_BATCHES = (3,)           # the config's batch; bs 24 cut for path 14
# K1 per G forward at 256²: 8 style-MLP layers per code, 13 StyleConvs;
# per D forward (channel multiplier 2): the 1×1 ConvLayer, two in each of
# 6 ResBlocks, final_conv and final_linear's first layer
K1_PER_SG2_G = {1: 8 + 13, 2: 2 * 8 + 13}
K1_PER_SG2_D = 15
# the four FUSE settings: (FUSE_UP, FUSE_DOWN)
FUSE_SETTINGS = {"off": (False, False), "up": (True, False),
                 "down": (False, True), "both": (True, True)}
# the settings timed (all four are checked); up and down cut for path 14
FUSE_SPEED_SETTINGS = ("off", "both")
FUSE_SPEED_BATCHES = (16, 32)  # bs 1 cut to make room for path 15
FUSED_FLOAT_TOL = 2e-4       # of max|y|, flagged vs unflagged float output
# the path piece at 512 channels: the card's error against float64 at most
# this many times the CPU's largest float32 error (plus LOSS_RTOL or
# GRAD_TOL)
PATH_F64_FACTOR = 4
# the tiny overrides of tests/test_option_zoo.py:309-323
SG2_TINY = ["network_g:out_size=32", "network_g:num_style_feat=16",
            "network_g:num_mlp=2", "network_g:channel_multiplier=0.25",
            "network_d:out_size=32", "network_d:channel_multiplier=0.25",
            "train:net_d_reg_every=2", "train:net_g_reg_every=2"]


@contextlib.contextmanager
def fuse_flags(up, down):
    """`ops/fused_resample.py`'s FUSE_UP / FUSE_DOWN set inside the block
    (the callers read them at every call), restored after."""
    from image_restoration_tpu_torch.ops import fused_resample as fr
    old = (fr.FUSE_UP, fr.FUSE_DOWN)
    fr.FUSE_UP, fr.FUSE_DOWN = up, down
    try:
        yield
    finally:
        fr.FUSE_UP, fr.FUSE_DOWN = old


def _ranged(name, fn):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def _range_ms(prof, key):
    """Device ms under the profiler range `key` (its CPU-side events)."""
    return sum(getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0)) / 1e3
               for e in prof.key_averages()
               if e.key == key and getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CPU)


def _fused_op_ranges():
    """Patches that wrap each fused-resample call site in the profiler
    range irt.fused_resample."""
    from image_restoration_tpu_torch.archs import stylegan2_arch
    from image_restoration_tpu_torch.ops import modulated_conv
    return [mock.patch.object(mod, name, _ranged("irt.fused_resample",
                                                 getattr(mod, name)))
            for mod, name in ((modulated_conv, "conv_up_fir"),
                              (modulated_conv, "conv_down_fir"),
                              (stylegan2_arch, "conv_down_fir"))]


def phase_fuse_restore():
    """Phase 34: FUSE_UP / FUSE_DOWN on the restore at PRODUCTION_GFPGAN,
    in the four settings. TF32 off: each flagged forward against the
    unflagged one at the same weights (float32: ≤1 LSB on the uint8
    output, ≤2e-4·max|y| on the float one; dyn-int8, where the fused path
    quantizes the FIR-folded weight, so the operands differ: ≥30 dB, the
    serving gate, with the worst LSB printed), and K1 39 per forward in
    every setting. TF32 at PyTorch's defaults, in FUSE_SPEED_SETTINGS:
    device ms of a bs-16 forward (calls back to back), imgs/s at
    FUSE_SPEED_BATCHES, and a profile
    of a bs-16 forward with the FIR depthwise convs' and the fused ops'
    shares of device time."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.ops import fused_act
    restorer = Restorer(PRODUCTION_GFPGAN, device="cuda", seed=0)
    randomize_weights(restorer.net, seed=1)
    q = Restorer(PRODUCTION_GFPGAN, quant="dyn-int8", device="cuda", seed=0)
    q.net.load_state_dict(restorer.net.state_dict())
    imgs = np.stack([plate_image(256, 256, seed=3400 + i)[..., ::-1]
                     for i in range(32)])
    u8 = {bs: imgs[:bs].copy() for bs in FUSE_SPEED_BATCHES}
    x4 = torch.from_numpy(imgs[:4].copy()).cuda().float() / 255.0
    x4 = (x4 - restorer._mean_t) / restorer._std_t

    def run(r):
        return (r.restore_batch_u8(imgs[:4]), r._fwd(x4).float())

    old = _tf32_off()
    try:
        ref = {name: run(r) for name, r in (("float32", restorer),
                                            ("dyn-int8", q))}
        check = {}
        for setting, flags in FUSE_SETTINGS.items():
            with fuse_flags(*flags):
                for name, r in (("float32", restorer), ("dyn-int8", q)):
                    fused_act.fused_leaky_relu.launches = 0
                    r.restore_batch_u8(imgs[:1])
                    torch.cuda.synchronize()
                    k1 = fused_act.fused_leaky_relu.launches
                    require(k1 == K1_LAUNCHES_PER_FORWARD,
                            f"FUSE {setting} {name}: K1 {k1} per forward")
                    got_u8, got_f = run(r)
                    lsb = _lsb(got_u8, ref[name][0])
                    dfloat = float((got_f - ref[name][1]).abs().max()
                                   / ref[name][1].abs().max())
                    db = _psnr_u8(got_u8, ref[name][0])
                    require(bool(torch.isfinite(got_f).all()),
                            f"FUSE {setting} {name}: non-finite output")
                    if name == "float32":
                        require(lsb <= 1 and dfloat <= FUSED_FLOAT_TOL,
                                f"FUSE {setting} float32 vs unflagged: "
                                f"{lsb} LSB, {dfloat:.3g} of max|y|")
                    else:
                        require(db >= DYN_INT8_GATE_DB,
                                f"FUSE {setting} dyn-int8 vs unflagged: "
                                f"{db:.2f} dB")
                    check[f"{setting}/{name}"] = dict(
                        max_lsb=lsb, float_rel=dfloat, psnr_db=db, k1=k1)
                    log(f"FUSE {setting:4s} {name:8s} vs unflagged (TF32 "
                        f"off, bs 4): max {lsb} LSB, float max|d| "
                        f"{dfloat:.3g} of max|y|, {db:.2f} dB; K1 {k1} "
                        "per forward")
    finally:
        _tf32_restore(old)

    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    x16 = torch.from_numpy(u8[16]).cuda().float() / 255.0
    x16 = (x16 - restorer._mean_t) / restorer._std_t
    speed = {}
    for setting in FUSE_SPEED_SETTINGS:
        with fuse_flags(*FUSE_SETTINGS[setting]):
            # a whole forward takes the host longer to enqueue than the
            # device to run, and its ≈ 600 launches fill much of the CUDA
            # launch queue: windows of one forward behind a ≈ 300 ms sleep
            fwd_ms = device_time_ms(lambda: restorer._fwd(x16), [()], 6,
                                    calls=1, cycles=15 * HOLD_CYCLES)
            rates = {}
            for bs in FUSE_SPEED_BATCHES:
                for _ in range(3):
                    restorer.restore_batch_u8(u8[bs])
                torch.cuda.synchronize()
                times = []
                for _ in range(20 if bs > 1 else 40):
                    t0 = time.perf_counter()
                    restorer.restore_batch_u8(u8[bs])
                    times.append(time.perf_counter() - t0)
                rates[bs] = bs / float(np.median(times))
            patches = _fused_op_ranges()
            for p in patches:
                p.start()
            try:
                from torch.profiler import ProfilerActivity, profile
                for _ in range(2):
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        restorer._fwd(x16)
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                    kernels = [k for k in _kernel_events(prof)
                               if not k[2].startswith("irt.")]
                    k1_n = sum(k[1] for k in kernels
                               if "fused_bias_lrelu" in k[2])
                    if k1_n == K1_LAUNCHES_PER_FORWARD:
                        break
                    log(f"profiler saw {k1_n} K1 launches: profiling again")
            finally:
                for p in patches:
                    p.stop()
            busy = sum(k[0] for k in kernels)
            fir = sum(k[0] for k in kernels
                      if any(key in k[2] for key in FIR_KERNEL_KEYS))
            fused_ms = _range_ms(prof, "irt.fused_resample")
        speed[setting] = dict(fwd_bs16_device_ms=fwd_ms,
                              imgs_per_s={str(b): v for b, v in
                                          rates.items()},
                              profile_wall_ms=wall, busy_ms=busy,
                              fir_ms=fir, fir_share=fir / busy,
                              fused_ms=fused_ms, fused_share=fused_ms / busy,
                              top=[dict(ms=t, count=n, name=name[:160])
                                   for t, n, name in kernels[:8]])
        log(f"FUSE {setting:4s}: bs-16 forward {fwd_ms:.4f} device ms; "
            "imgs/s " + ", ".join(f"bs {b} {v:.2f}" for b, v in
                                  rates.items())
            + f"; profile bs 16: busy {busy:.3f} of {wall:.3f} ms, FIR "
            f"depthwise {fir:.3f} ms ({100 * fir / busy:.1f}%), fused ops "
            f"{fused_ms:.3f} ms ({100 * fused_ms / busy:.1f}%)")
        for t, n, name in kernels[:6]:
            log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    best = min(speed, key=lambda s: speed[s]["fwd_bs16_device_ms"])
    log(f"FUSE: fastest bs-16 forward on the device: {best}")
    del restorer, q
    torch.cuda.empty_cache()
    return dict(check=check, speed=speed, fastest_device=best)


def sg2_options(root, extra=()):
    """The StyleGAN2 config (`parse_options`) with `extra` --force_yml
    overrides and its GT folder in `root`."""
    from image_restoration_tpu_torch.utils.options import parse_options
    argv = ["-opt", SG2_CONFIG, "--force_yml",
            f"datasets:train:dataroot_gt={root}/gt",
            "datasets:train:io_backend={type: disk}", *extra]
    return parse_options(root, argv=argv)[0]


def sg2_path_piece(model, codes, index, noise, img_noise):
    """The path-length penalty (batch of `img_noise`) and its G grads, no
    update: ({l_g_path, path_length, mean_path_length}, grads)."""
    model.net_g.zero_grad(set_to_none=True)
    pb = img_noise.shape[0]
    l_path, path_len, new_mean = model.path_loss(
        [c[:pb] for c in codes], index, noise, img_noise)
    l_path.backward()
    grads = _grads(model.net_g)
    model.net_g.zero_grad(set_to_none=True)
    return {"l_g_path": float(l_path.detach()),
            "path_length": float(path_len),
            "mean_path_length": float(new_mean)}, grads


def sg2_pieces(model, real, codes, index, noise, img_noise):
    """Losses and gradients of the StyleGAN2 step's pieces, no update: the
    D loss at a no-grad fake and its D grads, the G loss and G grads, R1
    and its D grads, and `sg2_path_piece`."""
    g, d = model.net_g, model.net_d
    g.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    with torch.no_grad():
        fake = model.g_forward(codes, index, noise)
    d.requires_grad_(True)
    l_d, real_s, fake_s = model.d_loss(fake, real)
    l_d.backward()
    d_grads = _grads(d)
    d.zero_grad(set_to_none=True)
    d.requires_grad_(False)
    l_g = model.g_loss(codes, index, noise)
    l_g.backward()
    g_grads = _grads(g)
    g.zero_grad(set_to_none=True)
    d.requires_grad_(True)
    l_r1 = model.r1_loss(real)
    l_r1.backward()
    r1_grads = _grads(d)
    d.zero_grad(set_to_none=True)
    path, path_grads = sg2_path_piece(model, codes, index, noise, img_noise)
    losses = dict(l_d=l_d, real_score=real_s, fake_score=fake_s, l_g=l_g,
                  l_d_r1=l_r1)
    return (dict({k: float(v.detach()) for k, v in losses.items()}, **path),
            fake.detach(), dict(d=d_grads, g=g_grads, r1=r1_grads,
                                path=path_grads))


def _without_path(pieces):
    losses, out, grads = pieces
    return ({k: v for k, v in losses.items()
             if k not in ("l_g_path", "path_length", "mean_path_length")},
            out, {k: v for k, v in grads.items() if k != "path"})


def compare_path_to_float64(cases, what):
    """The path-length pieces of the card (float32) and of the CPU
    (float32) against the CPU in float64 (`sg2_path_piece` results), over
    `cases` of (name, card, cpu, float64) on one network: float32's own
    error here is the CPU's largest over the cases (each loss relative, the
    G grads of max|grad|), and the card's error in each case must stay
    within PATH_F64_FACTOR times it, plus LOSS_RTOL or GRAD_TOL."""
    def errs(got, ref):
        scale = max(float(g.abs().max()) for g in ref[1])
        out = {k: abs(got[0][k] - r) / abs(r) for k, r in ref[0].items()}
        out["grads"] = max(float((a.double().cpu() - b).abs().max())
                           for a, b in zip(got[1], ref[1])) / scale
        return out

    card = {name: errs(c, r) for name, c, _, r in cases}
    cpu = {name: errs(c, r) for name, _, c, r in cases}
    pooled = {k: max(e[k] for e in cpu.values())
              for k in next(iter(cpu.values()))}
    for name, e in card.items():
        log(f"{what}, {name}: error against float64 (card / CPU float32): "
            + ", ".join(f"{k} {v:.3g}/{cpu[name][k]:.3g}"
                        for k, v in e.items()))
        for k, v in e.items():
            floor = GRAD_TOL if k == "grads" else LOSS_RTOL
            require(v <= PATH_F64_FACTOR * pooled[k] + floor,
                    f"{what}, {name}: {k} card {v:.3g} from float64, CPU "
                    f"float32 up to {pooled[k]:.3g}")
    return dict(card=card, cpu=cpu)


def _sg2_inputs(model, bs, seed, device):
    g = torch.Generator().manual_seed(seed)
    real = (torch.rand((bs, *model._hw, 3), generator=g) * 2 - 1)
    codes = [torch.randn((bs, model.num_style_feat), generator=g)
             for _ in range(2)]
    noise = [torch.randn(s, generator=g) for s in model.net_g.noise_shapes()]
    img_noise = torch.randn((model.path_batch(bs), *model._hw, 3),
                            generator=g)
    return (real.to(device), [c.to(device) for c in codes],
            [n.to(device) for n in noise], img_noise.to(device))


def _cuda(xs):
    return [x.cuda() for x in xs]


def _sg2_pair(root, extra, seed):
    """The StyleGAN2 model of the config with `extra` overrides on the CPU
    and on the card, at the same random weights."""
    from image_restoration_tpu_torch.models import build_model
    opt = sg2_options(root, extra)
    cpu = build_model(opt, device="cpu")
    card = build_model(opt, device="cuda")
    randomize_weights(cpu.net_g, seed=seed)
    randomize_weights(cpu.net_d, seed=seed + 1)
    for name in ("net_g", "net_d"):
        getattr(card, name).load_state_dict(getattr(cpu, name).state_dict())
    return cpu, card


def phase_sg2_card_vs_cpu(root):
    """Phase 35, TF32 off and cuDNN deterministic: the tiny StyleGAN2 config
    (32²) on the card against the CPU, the pieces of a D+G, an R1 and a
    path-length step with one style and with two (index 3). Losses within
    1e-5 relative, gradients within 1e-4 of max|grad|, mean_path_length
    within 1e-5, except the path-length piece at the overrides' 512
    channels: there float32 itself is 1e-3 from float64 (the demodulation
    makes G nearly invariant to a style's scale, so the path gradient is a
    difference of near-equal terms), so the card and the CPU are each held
    against the CPU in float64, the card at most PATH_F64_FACTOR times as
    far as the CPU's float32 is at its farthest over the two cases
    (`compare_path_to_float64`); at narrow 1/8 the whole path piece is
    held card vs CPU at the tolerances above. Then one full-width
    path-length step (the config's G, path batch 1, two styles) with K1's
    kernel against the same on K1's plain version: K1's double backward,
    at the tolerances above, K1 29 launches."""
    import copy
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.ops import fused_act
    old = _tf32_off()
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        cpu, card = _sg2_pair(root, SG2_TINY, 35)
        cpu64 = copy.deepcopy(cpu)
        cpu64.net_g.double()
        real, codes, noise, img_noise = _sg2_inputs(cpu, 4, 35, "cpu")
        cases = []
        for n, index in ((1, None), (2, 3)):
            what = f"tiny StyleGAN2, {n} style(s), card vs CPU (TF32 off)"
            want = sg2_pieces(cpu, real, codes[:n], index, noise, img_noise)
            got = sg2_pieces(card, real.cuda(), _cuda(codes[:n]), index,
                             _cuda(noise), img_noise.cuda())
            res[f"styles_{n}"] = compare_pieces(
                _without_path(got), _without_path(want), what)
            ref = sg2_path_piece(cpu64, [c.double() for c in codes[:n]],
                                 index, [x.double() for x in noise],
                                 img_noise.double())
            cases.append((f"{n} style(s)", (got[0], got[2]["path"]),
                          (want[0], want[2]["path"]), ref))
        res["path_vs_float64"] = compare_path_to_float64(
            cases, "tiny StyleGAN2 path-length piece")
        del cpu, card, cpu64
        narrow = [f"network_{n}:narrow=0.125" for n in ("g", "d")]
        cpu, card = _sg2_pair(root, SG2_TINY + narrow, 38)
        real, codes, noise, img_noise = _sg2_inputs(cpu, 4, 38, "cpu")
        want = sg2_pieces(cpu, real, codes, 3, noise, img_noise)
        got = sg2_pieces(card, real.cuda(), _cuda(codes), 3, _cuda(noise),
                         img_noise.cuda())
        res["narrow_styles_2"] = compare_pieces(
            got, want, "tiny StyleGAN2 at narrow 1/8, 2 styles, card vs CPU "
            "(TF32 off)")
        del cpu, card

        full = build_model(sg2_options(root), device="cuda")
        randomize_weights(full.net_g, seed=37)
        _, codes, noise, img_noise = _sg2_inputs(full, 3, 37, "cuda")
        codes = [c[:1] for c in codes]

        def path_piece():
            fused_act.fused_leaky_relu.launches = 0
            losses, grads = sg2_path_piece(full, codes, 7, noise, img_noise)
            torch.cuda.synchronize()
            k1 = fused_act.fused_leaky_relu.launches
            with torch.no_grad():
                fake = full.g_forward(codes, 7, noise)
            return (losses, fake, dict(path=grads)), k1

        k, k1 = path_piece()
        require(k1 == K1_PER_SG2_G[2], f"full-width path step: K1 {k1}, "
                f"expected {K1_PER_SG2_G[2]}")
        with mock.patch.object(fused_act, "fused_leaky_relu",
                               fused_act.fused_leaky_relu_plain):
            p, _ = path_piece()
    finally:
        _tf32_restore(old)
        torch.backends.cudnn.deterministic = old_det
    require(all(math.isfinite(v) for v in k[0].values()), "non-finite loss")
    res["full_width_path_k1_vs_plain"] = dict(
        compare_pieces(k, p, "full-width path-length step, K1 vs plain K1 "
                       "(TF32 off)"), losses=k[0], k1=k1)
    del full
    torch.cuda.empty_cache()
    return res


def write_faces(folder, n, seed):
    import cv2
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"{i:05d}.png"),
                    scene_image(256, 256, seed + i))


def phase_sg2_main_path(root):
    """Phase 36, the main path: counts at 0, then `train_pipeline` on the
    StyleGAN2 config as written (StyleGAN2Generator 256², 512 style
    features, 8 MLP layers, channel multiplier 2; the D at 2; batch 3),
    cut with --force_yml to the disk backend over 16 seeded 256² images
    and 32 iterations with a checkpoint at 32; K1 exactly what the step's
    forwards predict from the model's own draws, K2 and K3 never; every
    loss finite; `net_g_32.pth` in a fresh StyleGAN2Generator samples 8
    images at truncation 0.7 around `mean_latent(4096)` equal to the
    trained EMA G's on the same codes and noise."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.convert.pth import load_pth
    from image_restoration_tpu_torch.train import train_pipeline
    write_faces(f"{root}/gt", SG2_IMAGES, 3600)
    argv = ["-opt", SG2_CONFIG, "--force_yml",
            f"datasets:train:dataroot_gt={root}/gt",
            "datasets:train:io_backend={type: disk}",
            f"train:total_iter={SG2_ITERS}",
            f"logger:save_checkpoint_freq={SG2_ITERS}", "logger:print_freq=8"]
    log("path 8 cuts (--force_yml): " + " ".join(argv[3:]))
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = (k.launches for k in kernels)
    draws = dict(model.style_draws)
    n_r1 = SG2_ITERS // model.net_d_reg_every
    g_forwards = sum(c * K1_PER_SG2_G[n] for (_, n), c in draws.items())
    d_forwards = SG2_ITERS * 3 + n_r1
    want = g_forwards + d_forwards * K1_PER_SG2_D
    log(f"StyleGAN2 train_pipeline: {SG2_ITERS} iterations in {wall:.2f} s "
        "(wall: build and saves included); drawn G forwards (part, codes): "
        f"{sorted(draws.items())}; K1 expected = Σ draws × (21 one code, 29 "
        f"two) + (3·{SG2_ITERS} + {n_r1} R1) D forwards × {K1_PER_SG2_D} = "
        f"{g_forwards} + {d_forwards * K1_PER_SG2_D} = {want}; K1 {k1}, "
        f"K2 {k2}, K3 {k3}; last losses "
        + ", ".join(f"{k}={v:.4g}" for k, v in model.log_dict.items()))
    require(k1 == want, f"StyleGAN2 main path: K1 {k1}, expected {want}")
    require(k2 == 0 and k3 == 0, "StyleGAN2 main path launched K2 or K3")
    require(model.iter == SG2_ITERS, f"model.iter {model.iter}")
    require({"l_d_r1", "l_g_path"} <= set(model.log_dict),
            "R1 or the path step did not run at the last step")
    require(all(math.isfinite(v) for v in model.log_dict.values()),
            "a non-finite loss")
    require(sum(c for (p, n), c in draws.items() if n == 2) > 0,
            "no step mixed styles")
    mdir = model.opt["path"]["models"]
    pth = os.path.join(mdir, f"net_g_{SG2_ITERS}.pth")
    require(os.path.exists(pth) and os.path.exists(
        os.path.join(mdir, f"ckpt_{SG2_ITERS}.pth")), "no checkpoint")

    fresh = build_network(model.opt["network_g"]).cuda().eval()
    fresh.load_state_dict(load_pth(pth, "params_ema"), strict=True)
    g = torch.Generator("cuda").manual_seed(36)
    codes = [torch.randn((8, model.num_style_feat), generator=g,
                         device="cuda")]
    noise = [torch.randn(s, generator=g, device="cuda")
             for s in fresh.noise_shapes()]
    with torch.no_grad():
        mean = fresh.mean_latent(4096, torch.Generator("cuda").manual_seed(4))
        got = fresh(codes, noise=noise, truncation=0.7,
                    truncation_latent=mean)[0]
        want_mean = model.net_g_ema.mean_latent(
            4096, torch.Generator("cuda").manual_seed(4))
        want_img = model.net_g_ema(codes, noise=noise, truncation=0.7,
                                   truncation_latent=want_mean)[0]
    require(got.shape == (8, 256, 256, 3) and bool(torch.isfinite(got).all()),
            f"samples {tuple(got.shape)} not finite")
    d = float((got - want_img).abs().max())
    log(f"net_g_{SG2_ITERS}.pth in a fresh StyleGAN2Generator: 8 samples at "
        f"truncation 0.7 around mean_latent(4096), max|d| {d:.3g} against "
        f"the trained EMA G; sample std {got.std().item():.4f}")
    require(torch.equal(got, want_img), f"samples differ by {d}")
    return model, dict(k1=k1, k1_expected=want, draws={
        f"{p}/{n}": c for (p, n), c in draws.items()}, wall_s=wall,
        last_losses=model.log_dict, sample_max_abs_diff=d)


def sg2_timed_steps(model, pool, iters):
    """Seconds of each of `iters` optimize_parameters calls as a training
    loop runs them (CUDA events, no synchronize between steps), on numpy
    batches from `pool`; and the peak device MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for it in range(1, iters + 1):
        model.optimize_parameters(it, {"gt": pool[it % len(pool)]})
        events[it].record()
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])],
            torch.cuda.max_memory_allocated() / 2 ** 20)


def sg2_step_profile(model, batch, it):
    """(wall ms, busy ms, K1 forward ms, K1 backward-ops ms, K1 launches
    seen, K1 launches the step's draws predict, kernels) of one profiled
    optimize_parameters at iteration `it`; taken again (up to 3 times)
    while the profiler shows another K1 count than the draws predict. The
    profiler can drop device events late in a long process (1 of 103 of
    them in a whole run of this script on an H100), so the last profile is
    kept then and the count it missed is logged: the wrapper's own count
    holds K1 on the main path (phase 36)."""
    from torch.profiler import ProfilerActivity, profile
    from image_restoration_tpu_torch.ops import fused_act
    patch = mock.patch.object(
        fused_act, "fused_leaky_relu_backward",
        _ranged("irt.k1_backward", fused_act.fused_leaky_relu_backward))
    patch.start()
    try:
        for _ in range(2):
            before = dict(model.style_draws)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.optimize_parameters(it, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            new = {k: v - before.get(k, 0)
                   for k, v in model.style_draws.items()}
            d_fwd = 3 + (it % model.net_d_reg_every == 0)
            want = sum(c * K1_PER_SG2_G[n] for (_, n), c in new.items()) \
                + d_fwd * K1_PER_SG2_D
            kernels = [k for k in _kernel_events(prof)
                       if not k[2].startswith(("irt.", "Optimizer."))]
            k1_n = sum(k[1] for k in kernels if "fused_bias_lrelu" in k[2])
            if k1_n == want:
                break
            log(f"profiler saw {k1_n} of {want} K1 launches: profiling again")
    finally:
        patch.stop()
    if k1_n != want:
        log(f"StyleGAN2 step profile: the profiler shows {k1_n} of {want} "
            "K1 launches; busy ms below misses those events")
    busy = sum(k[0] for k in kernels)
    k1_fwd = sum(k[0] for k in kernels if "fused_bias_lrelu" in k[2])
    return wall, busy, k1_fwd, _range_ms(prof, "irt.k1_backward"), k1_n, \
        want, kernels


def phase_sg2_throughput(root, model3):
    """Phase 37: s per step (median of steps 5-16 of a loop with no
    synchronize between steps; R1 at 16, the path step every 4),
    imgs/s and peak MiB at bs 3 (the trained model); the R1 step's and the path-length step's ms alone; the
    device-busy share of one profiled bs-3 D+G step and of one with the
    path step, with K1's forward and its PyTorch-op backward. TF32 at
    PyTorch's defaults."""
    from image_restoration_tpu_torch.models import build_model
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    faces = np.stack([scene_image(256, 256, 3700 + i)[..., ::-1]
                      for i in range(48)]).astype(np.float32) / 127.5 - 1
    rows = {}
    for bs in SG2_BATCHES:
        model = model3 if bs == 3 else build_model(sg2_options(root),
                                                   device="cuda")
        pool = [faces[i * bs:(i + 1) * bs] for i in range(48 // bs)]
        times, peak = sg2_timed_steps(model, pool, TIMED_STEPS)
        step = float(np.median(times[4:]))
        real = torch.from_numpy(pool[0]).cuda()
        pb = model.path_batch(bs)

        def r1_step():
            model.optimizer_d.zero_grad()
            model.r1_loss(real).backward()
            model.optimizer_d.step()

        def path_step():
            codes, index = model.mixing_noise(pb, part="timing")
            noise = model.draw_noise()
            img_noise = torch.randn((pb, 256, 256, 3), device="cuda")
            model.optimizer_g.zero_grad()
            model.path_loss(codes, index, noise, img_noise)[0].backward()
            model.optimizer_g.step()

        r1_ms = host_time_ms(r1_step, [()], 5)
        path_ms = host_time_ms(path_step, [()], 5)
        rows[bs] = dict(s_per_step=step, imgs_per_s=bs / step,
                        peak_mib=peak, r1_step_ms=r1_ms,
                        path_step_ms=path_ms, path_batch=pb,
                        step_16_s=times[15])
        log(f"StyleGAN2 step bs={bs}: {step * 1e3:.2f} ms/step (median of "
            f"steps 5-{TIMED_STEPS}), {bs / step:.2f} imgs/s, peak {peak:.0f} "
            f"MiB; R1 step {r1_ms:.2f} ms, path step (batch {pb}) "
            f"{path_ms:.2f} ms; step 16 (R1 + path) "
            f"{times[15] * 1e3:.1f} ms")
        if bs != 3:
            del model
            torch.cuda.empty_cache()
    batch = {"gt": faces[:3]}
    prof = {}
    for it, what in ((5, "D+G"), (4, "D+G + path")):
        wall, busy, k1f, k1b, k1_n, k1_want, kernels = sg2_step_profile(
            model3, batch, it)
        prof[what] = dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                          k1_forward_ms=k1f, k1_backward_ops_ms=k1b,
                          k1_launches_seen=k1_n, k1_launches=k1_want,
                          top=[dict(ms=t, count=n, name=name[:160])
                               for t, n, name in kernels[:10]])
        log(f"profile of a bs-3 {what} step: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%), K1 forward "
            f"{k1f:.3f} ms over {k1_n} launches, K1's PyTorch-op backward "
            f"{k1b:.3f} ms")
        for t, n, name in kernels[:6]:
            log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    return dict(rows={str(k): v for k, v in rows.items()}, profile=prof)


def phase_stylegan2(tmp):
    """Path 8: phases 34-37."""
    fuse = phase_fuse_restore()
    tiny = phase_sg2_card_vs_cpu(tmp)
    model, main_path = phase_sg2_main_path(tmp)
    thr = phase_sg2_throughput(tmp, model)
    del model
    torch.cuda.empty_cache()
    return main_path["k1"], dict(fuse_restore=fuse, card_vs_cpu=tiny,
                                 main_path=main_path, throughput=thr)


# -------------------- path 9: the component Ds and the identity loss

COMP_CONFIG = "configs/train_gfpgan_plate_256x64_component.yml"
IDENTITY_CONFIG = "configs/train_gfpgan_plate_256_identity.yml"
COMP_ITERS = 32                     # R1 at 16 and 32, a checkpoint at 32
COMP_TIMED = ("component",)         # identity's timed steps cut for path 14
IDENTITY_ITERS = 16                 # R1 at 16
COMP_BS = 4                         # both configs' batch_size_per_gpu
COMP_HW = (64, 256)                 # the component config's plates
NUM_CHARS = 10
# one pass of the ten char Ds: five grouped ConvLayers, one K1 each
K1_PER_CHAR_PASS = 5
# a G+D step adds the char Ds on the fake and the real crops in the G loss
# (the real ones for the style loss) and on both in their own update
K1_PER_COMP_STEP = 4 * K1_PER_CHAR_PASS


def write_plate_set(folder, n, seed, hw=COMP_HW):
    """n synthetic plates of hw and the (n, 10, 4) char boxes of each, in
    `folder` and `folder`.npz."""
    import cv2
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"plate_{i:03d}.png"),
                    plate_image(hw[0], hw[1], seed + i))
    np.savez(f"{folder}.npz", boxes=char_boxes(n, seed, hw))


def char_boxes(n, seed, hw=COMP_HW):
    """(n, 10, 4) float32 [x1, y1, x2, y2]: ten char cells across a plate
    of hw, each jittered by a pixel or two."""
    h, w = hw
    rng = np.random.default_rng(seed)
    cell = w / (NUM_CHARS + 1)
    x1 = cell / 2 + cell * np.arange(NUM_CHARS) + rng.uniform(
        -2, 2, (n, NUM_CHARS))
    y1 = h * 0.2 + rng.uniform(-2, 2, (n, NUM_CHARS))
    return np.stack([x1, y1, x1 + cell * 0.8, y1 + h * 0.6],
                    -1).astype(np.float32)


def comp_options(root, iters=COMP_ITERS, config=COMP_CONFIG):
    """argv for `train_pipeline` on a config of path 9 with its dataroots
    (and the component config's boxes) in `root`, cut to `iters` steps."""
    argv = ["-opt", config, "--force_yml",
            f"datasets:train:dataroot_gt={root}/train",
            f"datasets:val:dataroot_gt={root}/val",
            f"train:total_iter={iters}", f"val:val_freq={iters}",
            f"logger:save_checkpoint_freq={iters}", "logger:print_freq=8"]
    if config == COMP_CONFIG:
        argv += [f"datasets:train:component_path={root}/train.npz",
                 f"datasets:val:component_path={root}/val.npz"]
    return argv


def build_comp_trainer(root, config=COMP_CONFIG, device="cuda"):
    """The config's GFPGANModel (random weights from manual_seed) with its
    degradation pipeline."""
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.utils.options import parse_options
    opt, _ = parse_options(root, argv=comp_options(root, config=config))
    model = build_model(opt, device=device)
    model.set_degradation_pipeline(train_degradation(opt, root))
    return model


def k1_calls(fn):
    """The K1 calls fn() makes, counted on K1's plain version (nothing is
    launched)."""
    from image_restoration_tpu_torch.ops import fused_act
    n = [0]
    plain = fused_act.fused_leaky_relu_plain

    def count(*a, **k):
        n[0] += 1
        return plain(*a, **k)

    with mock.patch.object(fused_act, "fused_leaky_relu", count), \
            torch.no_grad():
        fn()
    return n[0]


def net_k1_counts(model, hw):
    """K1 calls of one training G forward, one D forward and one
    validation forward (the EMA G) of `model`'s nets at hw, counted on the
    nets themselves."""
    x = torch.zeros((1, hw[0], hw[1], 3), device=model.device)
    g = k1_calls(lambda: model.g_forward(x, model.draw_noise()))
    d = k1_calls(lambda: model.net_d(x))
    test = k1_calls(lambda: model._test_out(x))
    return g, d, test


def comp_batch(n, seed, hw=COMP_HW):
    """A GT batch of n synthetic plates (RGB float [0, 1]) at hw and its
    char boxes."""
    gt = np.stack([plate_image(hw[0], hw[1], seed + i)[..., ::-1]
                   for i in range(n)]).astype(np.float32) / 255.0
    return {"gt": gt, "char_boxes": char_boxes(n, seed, hw)}


def phase_comp_card_checks(root):
    """Phase 38, TF32 off and cuDNN deterministic: K1 against its plain
    version at every (M, C) of a pass of the ten char Ds at bs 4 (f32, with
    device times); `roi_align` card vs CPU (forward and the gradient to
    the image); the tiny (32²) component + identity step's pieces card vs
    CPU; one full-width G+D and R1 step of the component config with K1's
    kernel against the same on K1's plain version."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.ops import fused_act
    from image_restoration_tpu_torch.ops.roi_align import roi_align
    res = {}
    # K1 at the char Ds' shapes: (B·64², 640), (B·32², 1280) ×2,
    # (B·16², 2560) ×2
    dc = build_network(dict(type="FacialComponentDiscriminator",
                            groups=NUM_CHARS)).cuda()
    crops = torch.zeros((NUM_CHARS, COMP_BS, 64, 64, 3), device="cuda")
    shapes = []
    plain = fused_act.fused_leaky_relu_plain

    def rec(x, bias=None, negative_slope=0.2, scale=fused_act.SQRT2):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, bias, negative_slope, scale)

    with mock.patch.object(fused_act, "fused_leaky_relu", rec), \
            torch.no_grad():
        dc.forward_stacked(crops)
    require(len(shapes) == K1_PER_CHAR_PASS, f"char D pass: {shapes}")
    del dc, crops
    gen = torch.Generator(device="cuda").manual_seed(38)
    rows = []
    for m, c in sorted(set(shapes)):
        x = torch.randn((m, c), generator=gen, device="cuda")
        b = torch.randn((c,), generator=gen, device="cuda")
        got = fused_act.fused_leaky_relu(x, b)
        want = plain(x, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= 1e-6 * max(1.0, float(want.abs().max())),
                f"K1 at the char D shape M={m} C={c}: max|d|={err}")
        xs = [(torch.randn((m, c), generator=gen, device="cuda"),)
              for _ in range(8)]
        row = dict(M=m, C=c, per_pass=shapes.count((m, c)), max_abs_err=err,
                   ms=device_time_ms(lambda t: fused_act.fused_leaky_relu(
                       t, b), xs, 100),
                   plain_ms=device_time_ms(lambda t: plain(t, b), xs, 100),
                   bound_ms=k1_bound_ms(m, c, 4))
        rows.append(row)
        log(f"K1 char D f32 M={m:7d} C={c:4d} x{row['per_pass']}/pass  "
            f"ms={row['ms']:.5f}  plain_ms={row['plain_ms']:.5f}  "
            f"bound_ms={row['bound_ms']:.5f}  max|d|={err:.3g}")
    per_pass = {k: sum(r[k] * r["per_pass"] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms")}
    log(f"K1 per pass of the ten char Ds (bs {COMP_BS}): "
        + ", ".join(f"{k}={v:.4f}" for k, v in per_pass.items()))
    res["k1_char_d"] = dict(rows=rows, per_pass=per_pass)

    old = _tf32_off()
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # roi_align, card vs CPU: forward and the gradient to the image
        b = comp_batch(COMP_BS, 3800)
        img = torch.from_numpy(b["gt"]) * 2 - 1
        boxes = torch.from_numpy(b["char_boxes"])
        g = torch.randn((COMP_BS, NUM_CHARS, 64, 64, 3),
                        generator=torch.Generator().manual_seed(38))
        outs = {}
        for dev in ("cpu", "cuda"):
            x = img.to(dev).clone().requires_grad_(True)
            y = roi_align(x, boxes.to(dev), 64)
            (y * g.to(dev)).sum().backward()
            outs[dev] = (y.detach().cpu(), x.grad.cpu())
        d_fwd = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
        d_grad = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
        g_scale = float(outs["cpu"][1].abs().max())
        log(f"roi_align card vs CPU (bs {COMP_BS}, {COMP_HW[0]}x"
            f"{COMP_HW[1]}, 10 boxes, 64²): forward max|d| {d_fwd:.3g}, "
            f"gradient max|d| {d_grad:.3g} (max|grad| {g_scale:.3g})")
        require(d_fwd <= 1e-6 and d_grad <= 1e-5 * g_scale,
                "roi_align card vs CPU")
        res["roi_align_card_vs_cpu"] = dict(fwd=d_fwd, grad=d_grad,
                                            grad_scale=g_scale)

        # the tiny component + identity step, card vs CPU
        opt = comp_tiny_opt(root)
        cpu = build_model(opt, device="cpu")
        card = build_model(opt, device="cuda")
        randomize_weights(cpu.net_g, seed=38)
        randomize_weights(cpu.net_d, seed=39)
        randomize_weights(cpu.net_d_char, seed=40)
        for name in ("net_g", "net_d", "net_d_char", "net_identity"):
            getattr(card, name).load_state_dict(
                getattr(cpu, name).state_dict())
        card.cri_perceptual.vgg.load_state_dict(
            cpu.cri_perceptual.vgg.state_dict())
        g41 = torch.Generator().manual_seed(41)
        gt = torch.rand((2, 32, 32, 3), generator=g41) * 2 - 1
        lq = (gt + 0.2 * torch.randn(gt.shape, generator=g41)).clamp(-1, 1)
        bx = torch.from_numpy(char_boxes(2, 41, (32, 32)))
        noise = [torch.randn(s, generator=g41)
                 for s in cpu.net_g.stylegan_decoder.noise_shapes()]
        want = gan_pieces(cpu, lq, gt, noise, bx)
        got = gan_pieces(card, lq.cuda(), gt.cuda(), [n.cuda() for n in noise],
                         bx.cuda())
        res["tiny_card_vs_cpu"] = compare_pieces(
            got, want, "tiny component + identity step, card vs CPU "
            "(TF32 off)")
        del cpu, card

        # one full-width step of the component config, K1 vs plain K1
        model = build_comp_trainer(root)
        randomize_weights(model.net_g, seed=42)
        randomize_weights(model.net_d, seed=43)
        randomize_weights(model.net_d_char, seed=44)
        g_k1, d_k1, test_k1 = net_k1_counts(model, COMP_HW)
        step_want = g_k1 + 3 * d_k1 + K1_PER_COMP_STEP + d_k1
        b = comp_batch(COMP_BS, 3900)
        gen_c = torch.Generator("cuda").manual_seed(42)
        with torch.no_grad():
            lq, gtn = model.degrade_fn(gen_c, torch.from_numpy(b["gt"]).cuda())
        noise = model.draw_noise(gen_c)
        bx = torch.from_numpy(b["char_boxes"]).cuda()
        fused_act.fused_leaky_relu.launches = 0
        k = gan_pieces(model, lq, gtn, noise, bx)
        torch.cuda.synchronize()
        k1 = fused_act.fused_leaky_relu.launches
        require(k1 == step_want, f"full-width component step: K1 {k1}, "
                f"expected {step_want}")
        with mock.patch.object(fused_act, "fused_leaky_relu", plain):
            p = gan_pieces(model, lq, gtn, noise, bx)
    finally:
        _tf32_restore(old)
        torch.backends.cudnn.deterministic = old_det
    require(all(math.isfinite(v) for v in k[0].values()), "non-finite loss")
    res["full_width_k1_vs_plain"] = dict(
        compare_pieces(k, p, "full-width component G+D and R1 step, K1 vs "
                       "plain K1 (TF32 off)"), losses=k[0], k1=k1,
        g_k1=g_k1, d_k1=d_k1)
    log(f"K1 launches at {COMP_HW[0]}x{COMP_HW[1]}: G {g_k1} and D {d_k1} "
        f"per forward (counted on the nets), the char Ds "
        f"{K1_PER_CHAR_PASS} per pass; one G+D and R1 step {k1}")
    del model
    torch.cuda.empty_cache()
    return res, (g_k1, d_k1, test_k1)


def comp_tiny_opt(root):
    """The tiny config (32²) with the component Ds and the identity loss
    (IResNet18 at 512 features), the production losses besides."""
    opt = tiny_train_opt(root)
    opt["path"]["models"] = f"{root}/tiny_comp"
    opt.update(use_component_loss=True,
               network_d_char={"type": "FacialComponentDiscriminator"},
               network_identity={"type": "IResNet18"})
    opt["train"] = dict(
        opt["train"], optim_component={"type": "Adam", "lr": 2e-3},
        gan_component_opt={"type": "GANLoss", "gan_type": "vanilla",
                           "loss_weight": 1.0},
        comp_style_weight=200, identity_weight=10)
    return opt


def _check_trained(model, iters, keys):
    require(model.iter == iters, f"model.iter {model.iter}")
    require(set(keys) <= set(model.log_dict),
            f"missing losses {sorted(set(keys) - set(model.log_dict))}")
    require(all(math.isfinite(v) for v in model.log_dict.values()),
            "a non-finite loss")


def phase_comp_main_path(root, g_k1, d_k1, test_k1):
    """Phase 39, the main path: counts at 0, then `train_pipeline` on the
    component config as written (GFPGANv1OCR 256x64, StyleGAN2Discriminator
    at channel multiplier 1, the ten char Ds, batch 4), cut with
    --force_yml to seeded synthetic plates and boxes in `root` and 32
    iterations (R1 at 16 and 32, validation and a checkpoint at 32);
    counts read: K1 exactly 32·(G + 3·D + 20) + 2·D + the validation's G
    forwards, from the nets' own counts, K2 and K3 never; every loss
    finite, every char D moved; --auto_resume from ckpt_32.pth restores
    the char Ds and their Adam bit-equal. Then the identity config for 16
    iterations with a random frozen IResNet18, counts likewise: l_identity
    finite, the IResNet unchanged."""
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.train import train_pipeline
    argv = comp_options(root)
    log("path 9 cuts (--force_yml): " + " ".join(argv[3:]))
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = (k.launches for k in kernels)
    val_forwards = 2 * TRAIN_VAL_IMAGES   # at 32 and after the last step
    want = (COMP_ITERS * (g_k1 + 3 * d_k1 + K1_PER_COMP_STEP)
            + (COMP_ITERS // 16) * d_k1 + val_forwards * test_k1)
    log(f"component train_pipeline: {COMP_ITERS} iterations in {wall:.2f} s "
        f"(wall: build, validation and saves included); K1 {k1} launches "
        f"(expected {COMP_ITERS}·({g_k1} G + 3·{d_k1} D + "
        f"{K1_PER_COMP_STEP} char Ds) + {COMP_ITERS // 16}·{d_k1} R1 + "
        f"{val_forwards}·{test_k1} validation = {want}), K2 {k2}, K3 {k3}; "
        "last losses " + ", ".join(f"{k}={v:.4g}"
                                   for k, v in model.log_dict.items()))
    require(k1 == want, f"component main path: K1 {k1}, expected {want}")
    require(k2 == 0 and k3 == 0, "component main path launched K2 or K3")
    keys = ([f"l_g_gan_char_{i}" for i in range(NUM_CHARS)]
            + [f"l_d_char_{i}" for i in range(NUM_CHARS)]
            + ["l_g_comp_style_loss", "l_d_r1", "l_g_gan"])
    fresh = build_model(model.opt, device="cuda")
    _check_trained(model, COMP_ITERS, keys)
    for i in range(NUM_CHARS):
        a = model.net_d_char.char_state_dict(i)
        b = fresh.net_d_char.char_state_dict(i)
        require(all(not torch.equal(a[k], b[k]) for k in a),
                f"char D {i} did not move")
    mdir = model.opt["path"]["models"]
    require(os.path.exists(os.path.join(mdir, f"ckpt_{COMP_ITERS}.pth")),
            "no checkpoint")
    resumed = train_pipeline(root, argv=argv + ["--auto_resume"])
    require(resumed.iter == COMP_ITERS, f"resumed at {resumed.iter}")
    for k, v in resumed.net_d_char.state_dict().items():
        require(torch.equal(v, model.net_d_char.state_dict()[k]),
                f"resumed char D {k} differs")
    sa = resumed.optimizer_dc.opt.state_dict()["state"]
    sb = model.optimizer_dc.opt.state_dict()["state"]
    require(sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sa
        for k in ("exp_avg", "exp_avg_sq")), "resumed char D Adam differs")
    log(f"--auto_resume from ckpt_{COMP_ITERS}.pth: the ten char Ds and "
        "their Adam bit-equal")
    del resumed, fresh
    torch.cuda.empty_cache()
    main = dict(k1=k1, k1_expected=want, wall_s=wall,
                last_losses=model.log_dict)

    # the identity config: 256² plates, a random frozen IResNet18
    id_root = f"{root}/identity"
    write_plates(f"{id_root}/train", 8, 4200)
    write_plates(f"{id_root}/val", TRAIN_VAL_IMAGES, 4300)
    id_argv = comp_options(id_root, IDENTITY_ITERS, IDENTITY_CONFIG)
    id_model_probe = build_comp_trainer(id_root, IDENTITY_CONFIG)
    id_g, id_d, id_test = net_k1_counts(id_model_probe, (256, 256))
    id_before = {k: v.clone() for k, v in
                 id_model_probe.net_identity.state_dict().items()}
    del id_model_probe
    kernels = _counts_zero()
    t0 = time.perf_counter()
    id_model = train_pipeline(id_root, argv=id_argv)
    torch.cuda.synchronize()
    id_wall = time.perf_counter() - t0
    id_k1, k2, k3 = (k.launches for k in kernels)
    id_want = (IDENTITY_ITERS * (id_g + 3 * id_d)
               + (IDENTITY_ITERS // 16) * id_d
               + 2 * TRAIN_VAL_IMAGES * id_test)
    log(f"identity train_pipeline: {IDENTITY_ITERS} iterations in "
        f"{id_wall:.2f} s; K1 {id_k1} (expected {IDENTITY_ITERS}·({id_g} + "
        f"3·{id_d}) + {id_d} R1 + {2 * TRAIN_VAL_IMAGES}·{id_test} validation "
        f"= {id_want}), K2 {k2}, K3 {k3}; l_identity "
        f"{id_model.log_dict.get('l_identity')}")
    require(id_k1 == id_want, f"identity main path: K1 {id_k1}, "
            f"expected {id_want}")
    require(k2 == 0 and k3 == 0, "identity main path launched K2 or K3")
    _check_trained(id_model, IDENTITY_ITERS,
                   ["l_identity", "l_d_r1", "l_g_gan"])
    for k, v in id_model.net_identity.state_dict().items():
        require(torch.equal(v, id_before[k]), f"the IResNet moved: {k}")
    log("the frozen IResNet18 is bit-unchanged after "
        f"{IDENTITY_ITERS} iterations")
    main["identity"] = dict(k1=id_k1, k1_expected=id_want, wall_s=id_wall,
                            g_k1=id_g, d_k1=id_d,
                            last_losses=id_model.log_dict)
    return model, id_model, main


def comp_timed_steps(model, pool, iters):
    """Seconds of each of `iters` optimize_parameters calls as a training
    loop runs them (CUDA events, no synchronize between steps), on batches
    from `pool`; the peak device MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for it in range(1, iters + 1):
        model.optimize_parameters(it, pool[it % len(pool)])
        events[it].record()
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])],
            torch.cuda.max_memory_allocated() / 2 ** 20)


def comp_step_profile(step, ranges):
    """(wall ms, busy ms, device ms under each range, kernel events) of one
    profiled call of `step()` (a training step); `ranges` maps a range name
    to (object, attribute) wrapped in it for this run."""
    from torch.profiler import ProfilerActivity, profile
    patches = [mock.patch.object(obj, attr, _ranged(name,
                                                    getattr(obj, attr)))
               for name, (obj, attr) in ranges.items()]
    for p in patches:
        p.start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    kernels = [k for k in _kernel_events(prof)
               if not k[2].startswith(("irt.", "Optimizer."))
               and k[2] not in ranges]
    busy = sum(k[0] for k in kernels)
    return wall, busy, {name: _range_ms(prof, name) for name in ranges}, \
        kernels


def phase_comp_throughput(comp_model, id_model):
    """Phase 40: s per step (median of steps 5-16 of a loop with no
    synchronize between steps; R1 at 16 and 32), trained imgs/s and peak
    MiB of the component and the identity config at bs 4; from a profiled
    step of each, the device-busy share and the device ms under the
    forward ranges of roi_align, the char Ds and the IResNet; the char
    Ds', roi_align's and the IResNet's forward + backward timed alone at
    the step's shapes."""
    from image_restoration_tpu_torch.models import gfpgan_model
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rows = {}
    pools = {"component": [comp_batch(COMP_BS, 4400 + 10 * i)
                           for i in range(2)],
             "identity": [{"gt": plate_batch(COMP_BS, 4500 + 10 * i)}
                          for i in range(2)]}
    for name, model in (("component", comp_model), ("identity", id_model)):
        torch.cuda.empty_cache()
        if name in COMP_TIMED:
            times, peak = comp_timed_steps(model, pools[name], TIMED_STEPS)
            step = float(np.median(times[4:]))
        else:  # its step's profile only
            times, peak, step = [float("nan")] * TIMED_STEPS, None, \
                float("nan")
        if name == "component":
            ranges = {"irt.roi_align": (gfpgan_model, "roi_align"),
                      "irt.char_ds_forward": (model.net_d_char, "forward")}
        else:
            ranges = {"irt.iresnet_forward": (model.net_identity, "forward")}
        wall, busy, range_ms, kernels = comp_step_profile(
            lambda: model.optimize_parameters(5, pools[name][0]), ranges)
        rows[name] = dict(s_per_step=step, imgs_per_s=COMP_BS / step,
                          peak_mib=peak, step_16_s=times[15],
                          profile_wall_ms=wall, busy_ms=busy,
                          busy_share_of_wall=busy / wall,
                          busy_share_of_step=busy / (step * 1e3),
                          range_ms=range_ms,
                          top=[dict(ms=t, count=n, name=k[:200])
                               for t, n, k in kernels[:12]])
        log(f"{name} step bs={COMP_BS}: " + (
            f"{step * 1e3:.2f} ms/step (median of steps 5-{TIMED_STEPS}), "
            f"{COMP_BS / step:.2f} imgs/s, step 16 (with R1) "
            f"{times[15] * 1e3:.1f} ms, peak "
            f"{peak:.0f} MiB; " if name in COMP_TIMED else "not timed; ")
            + f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} "
            f"ms ({100 * busy / wall:.1f}% of that wall, "
            f"{100 * busy / (step * 1e3):.1f}% of the median step); "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in range_ms.items()))
        for t, n, k in kernels[:8]:
            log(f"  {t:9.4f} ms  x{n:<4d} {k[:110]}")

    # forward + backward alone at the step's shapes
    m = comp_model
    b = comp_batch(COMP_BS, 4600)
    x = torch.from_numpy(b["gt"]).cuda() * 2 - 1
    xg = x.clone().requires_grad_(True)
    bx = torch.from_numpy(b["char_boxes"]).cuda()

    def roi_fb():
        gfpgan_model.roi_align(xg, bx, 64).sum().backward()

    def g_side_fb():
        m.net_d_char.requires_grad_(False)
        l_char, l_cs = m.component_g_losses(xg, x, bx)
        (l_char.sum() + l_cs).backward()
        m.net_d_char.requires_grad_(True)

    def d_side_fb():
        m.component_d_losses(x, x.flip(1), bx).sum().backward()

    xi = torch.from_numpy(plate_batch(COMP_BS, 4700)).cuda() * 2 - 1
    xig = xi.clone().requires_grad_(True)

    def id_fb():
        id_model.identity_loss(xig, xi).backward()

    alone = {"roi_align_fwd_bwd": host_time_ms(roi_fb, [()], 10),
             "char_ds_g_side_fwd_bwd": host_time_ms(g_side_fb, [()], 10),
             "char_ds_d_side_fwd_bwd": host_time_ms(d_side_fb, [()], 10),
             "iresnet_identity_fwd_bwd": host_time_ms(id_fb, [()], 10)}
    m.net_d_char.zero_grad(set_to_none=True)
    for k, v in alone.items():
        log(f"  alone: {k:28s} {v:9.3f} ms")
    return dict(rows=rows, alone_ms=alone)


def phase_components(tmp):
    """Path 9: phases 38-40, on 8 plates (and their boxes) to train on and
    4 to validate."""
    write_plate_set(f"{tmp}/train", 8, 4000)
    write_plate_set(f"{tmp}/val", TRAIN_VAL_IMAGES, 4100)
    checks, counts = phase_comp_card_checks(tmp)
    comp, ident, main_path = phase_comp_main_path(tmp, *counts)
    thr = phase_comp_throughput(comp, ident)
    del comp, ident
    torch.cuda.empty_cache()
    return main_path["k1"] + main_path["identity"]["k1"], dict(
        card_checks=checks, main_path=main_path, throughput=thr)


# ------------------------------------- path 10: the detector trainer

DET_BS = 24                  # the Resnet18 cfg's batch_size, JAX's recipe
DET_TRAIN_IMAGES = 48        # two steps an epoch at bs 24
DET_EPOCHS = 3               # then one more after --resume_epoch 3
DET_EVAL_PHOTOS = 4
DET_TIMED_STEPS = TIMED_STEPS
DET_PARAM_TOL = 5e-3         # JAX's DP bound (tests/test_detect.py:160)
CONV_MIN_IOU = 0.90          # trained top-1 mean IoU; detection rate 1.0
BGR_MEAN = (104.0, 117.0, 123.0)


def write_label_tree(root, n, seed, size=DET_SIZE):
    """n synthetic plate scenes (detect/synth.py, drawn on the CPU) as
    JPEGs under root/images and the reference's label.txt: x y w h, five
    landmarks as x y conf, the flag."""
    import cv2
    from image_restoration_tpu_torch.detect.synth import make_batch
    imgs, targets = make_batch(torch.Generator().manual_seed(seed), n, size)
    os.makedirs(f"{root}/images", exist_ok=True)
    lines = []
    for i in range(n):
        cv2.imwrite(f"{root}/images/s{i}.jpg", np.clip(np.rint(
            imgs[i].numpy()), 0, 255).astype(np.uint8))
        t = targets[i, 0].numpy() * size
        box = (t[0], t[1], t[2] - t[0], t[3] - t[1])
        lines += [f"# s{i}.jpg", " ".join(f"{v:.2f}" for v in box) + " "
                  + " ".join(f"{x:.2f} {y:.2f} 0.0"
                             for x, y in t[4:14].reshape(5, 2)) + " 1"]
    with open(f"{root}/label.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return f"{root}/label.txt"


def phase_det_card_vs_cpu():
    """Phase 41: one DetectorTrainer step (mobilenet0.25, 64², bs 2, lr
    1e-2) on the card and on the CPU from the same weights and batch, TF32
    off: the matched labels equal and the loc and landmark targets within
    1e-6 of max|CPU| (a log and divisions: an ulp apart), losses within
    1e-5 relative, the
    running statistics within 1e-5 of max(1, max|CPU|), the parameters
    within JAX's DP bound of 5e-3."""
    from image_restoration_tpu_torch.detect.multibox_loss import \
        match_targets
    from image_restoration_tpu_torch.detect.synth import make_batch
    from image_restoration_tpu_torch.detect.train import DetectorTrainer
    old = _tf32_off()
    try:
        kw = dict(backbone="mobilenet0.25", image_size=64, lr=1e-2)
        cpu = DetectorTrainer(device="cpu", **kw)
        card = DetectorTrainer(device="cuda", **kw)
        card.net.load_state_dict(cpu.net.state_dict())
        imgs, tgts = make_batch(torch.Generator().manual_seed(4100), 2, 64)
        imgs = imgs - torch.tensor(BGR_MEAN)
        want_t = match_targets(tgts, cpu.priors)
        got_t = [t.cpu() for t in match_targets(tgts.cuda(), card.priors)]
        require(torch.equal(got_t[1], want_t[1]), "matched labels card vs CPU")
        target_rel = max(float((g - w).abs().max() / w.abs().max())
                         for g, w in zip(got_t, want_t))
        require(target_rel <= 1e-6, f"matched targets card vs CPU "
                f"{target_rel}")
        want = cpu.train_step(imgs, tgts)
        got = card.train_step(imgs, tgts)
        loss_rel = max(abs(float(got[k]) - float(v)) / abs(float(v))
                       for k, v in want.items())
        stats, params = 0.0, 0.0
        for k, w in cpu.net.state_dict().items():
            d = float((card.net.state_dict()[k].cpu().float()
                       - w.float()).abs().max())
            if "running" in k:
                stats = max(stats, d / max(1.0, float(w.abs().max())))
            elif not k.endswith("num_batches_tracked"):
                params = max(params, d)
    finally:
        _tf32_restore(old)
    log(f"detector step mobilenet0.25 64² bs 2, card vs CPU (TF32 off): "
        f"losses {loss_rel:.3g} relative, BN statistics {stats:.3g} of "
        f"max(1, |CPU|), parameters {params:.3g}; matched labels equal, "
        f"loc and landmark targets {target_rel:.3g} of max|CPU|")
    require(loss_rel <= LOSS_RTOL, f"detector losses {loss_rel}")
    require(stats <= 1e-5, f"detector BN statistics {stats}")
    require(params <= DET_PARAM_TOL, f"detector parameters {params}")
    return dict(loss_rel=loss_rel, stats_rel=stats, params_abs=params,
                target_rel=target_rel)


def phase_det_main_path(root):
    """Phase 42, main path: counts at 0; the CLI (`detect.train.main`) on
    a label.txt tree of 48 synthetic scenes, Resnet18 at 224², bs 24, 3
    epochs; again with --resume_net and --resume_epoch 3 for a fourth; its
    Resnet18_final.pth loaded strictly by PlateDetector(ckpt_path=…) (the
    trained weights and statistics, equal); a PlatePipeline on that
    detector serves one photo (K1 39 per GFPGAN forward, two forwards);
    `eval_detector` on a folder of 4 photos. Counts read: K1 exactly 78, K2
    and K3 never."""
    from image_restoration_tpu_torch.detect import train as det_train
    from image_restoration_tpu_torch.detect.engine import PlateDetector
    from image_restoration_tpu_torch.scripts import eval_detector
    from image_restoration_tpu_torch.serve.pipeline import PlatePipeline
    import cv2
    label = write_label_tree(f"{root}/train", DET_TRAIN_IMAGES, 4200)
    os.makedirs(f"{root}/photos", exist_ok=True)
    for i in range(DET_EVAL_PHOTOS):
        cv2.imwrite(f"{root}/photos/car{i}.jpg", car_photo(4300 + i))
    steps_per_epoch = DET_TRAIN_IMAGES // DET_BS
    common = ["--training_dataset", label, "--network", "resnet18",
              "--image_size", str(DET_SIZE), "--batch_size", str(DET_BS)]
    kernels = _counts_zero()
    t0 = time.perf_counter()
    tr1 = det_train.main(common + ["--epochs", str(DET_EPOCHS),
                                   "--save_folder", f"{root}/w1"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    require(tr1.step == DET_EPOCHS * steps_per_epoch,
            f"CLI trained {tr1.step} steps")
    ckpt1 = f"{root}/w1/Resnet18_final.pth"
    tr2 = det_train.main(common + [
        "--epochs", str(DET_EPOCHS + 1), "--resume_epoch", str(DET_EPOCHS),
        "--resume_net", ckpt1, "--save_folder", f"{root}/w2"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    require(tr2.step == (DET_EPOCHS + 1) * steps_per_epoch,
            f"resumed CLI ended at step {tr2.step}")
    ckpt = f"{root}/w2/Resnet18_final.pth"
    det = PlateDetector(backbone="Resnet18", ckpt_path=ckpt, device="cuda")
    trained = tr2.net.state_dict()
    for k, v in det.net.state_dict().items():
        require(torch.equal(v, trained[k]), f"detector .pth: {k} differs")
    pipe = PlatePipeline(detector=det, device="cuda", seed=0)
    for r in (pipe.plate_restorer, pipe.car_restorer):
        randomize_weights(r.net, seed=1)
    res = pipe.process(car_photo(4400))
    torch.cuda.synchronize()
    t = PIPE_TARGET
    require(res["montage"].shape == (t, 6 * t, 3)
            and res["montage"].dtype == np.uint8, "pipeline montage")
    k1_pipe = kernels[0].launches
    written = eval_detector.main([
        "-m", ckpt, "--network", "Resnet18",
        "--dataset_folder", f"{root}/photos", "--save_folder",
        f"{root}/txt", "--save_image", "--results_folder", f"{root}/vis"])
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]
    require(len(written) == DET_EVAL_PHOTOS and all(
        os.path.exists(f"{root}/txt/car{i}.txt")
        for i in range(DET_EVAL_PHOTOS)), "eval_detector's txt files")
    n_dets = [int(open(f"{root}/txt/car{i}.txt").read().split()[1])
              for i in range(DET_EVAL_PHOTOS)]
    log(f"detector CLI: {tr1.step} steps in {t1 - t0:.2f} s, resumed to "
        f"step {tr2.step} in {t2 - t1:.2f} s (wall: data, build and save "
        f"included), last losses " + ", ".join(
            f"{k}={float(v):.4g}" for k, v in tr2.last_losses.items()) +
        f"; .pth loaded strictly; pipeline detected={res['detected']}, "
        f"K1 {k1_pipe}; eval_detector wrote {len(written)} txt files "
        f"({n_dets} detections); K1/K2/K3 launches {counts}")
    require(counts == [2 * K1_LAUNCHES_PER_FORWARD, 0, 0],
            f"detector path: K1/K2/K3 launches {counts}")
    return counts[0], dict(cli_s=t1 - t0, resume_s=t2 - t1,
                           steps=tr2.step, detected=bool(res["detected"]),
                           eval_detections=n_dets)


def phase_det_convergence():
    """Phase 43: `detector_convergence` at its defaults (Resnet18, 224²,
    bs 24, 1500 iterations, ×0.1 at 70%, 16 held-out scenes), batches
    drawn on the card; the trained top-1 mean IoU at least 0.90 and the
    detection rate 1.0; no port kernel launched."""
    from image_restoration_tpu_torch.scripts.detector_convergence import run
    kernels = _counts_zero()
    t0 = time.perf_counter()
    rep = run()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    base, final = rep["eval_random_init"], rep["eval_trained"]
    log(f"detector convergence ({rep['iters']} iters, bs {rep['bs']}, "
        f"{rep['image_size']}²) in {wall:.1f} s: random init {base}, "
        f"trained {final}, loss {rep['loss_first10'][0]:.4g} → "
        f"{rep['loss_final']:.4g}, "
        f"{rep['s_per_step_after_first_chunk'] * 1e3:.2f} ms/step after "
        f"the first chunk; K1/K2/K3 launches {counts}")
    require(counts == [0, 0, 0], f"convergence: kernels {counts}")
    require(final["mean_iou"] >= CONV_MIN_IOU and final["det_rate"] == 1.0,
            f"the detector did not learn: {final}")
    return dict(rep, wall_s=wall)


def phase_det_speed():
    """Phase 44: s per Resnet18 step at 224², bs 24 (median of steps 5-16
    of a loop with no synchronize between steps, CUDA events after each;
    two pre-drawn device batches), imgs/s, peak MiB; a profiled step's
    device-busy share and the device time under the net's forward and
    under the matching + loss forward (`multibox_loss`)."""
    from image_restoration_tpu_torch.detect import train as det_train
    from image_restoration_tpu_torch.detect.synth import make_batch
    tr = det_train.DetectorTrainer(backbone="Resnet18", image_size=DET_SIZE,
                                   device="cuda")
    gen = torch.Generator("cuda").manual_seed(4500)
    mean = torch.tensor(BGR_MEAN, device="cuda")
    pool = []
    for _ in range(2):
        imgs, tgts = make_batch(gen, DET_BS, DET_SIZE)
        pool.append((imgs - mean, tgts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DET_TIMED_STEPS + 1)]
    events[0].record()
    for it in range(1, DET_TIMED_STEPS + 1):
        tr.train_step(*pool[it % 2])
        events[it].record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    step = float(np.median(times[4:]))
    ranges = {"det.net": (tr.net, "forward"),
              "det.multibox": (det_train, "multibox_loss")}
    wall, busy, under, _ = comp_step_profile(
        lambda: tr.train_step(*pool[0]), ranges)
    row = dict(s_per_step=step, imgs_per_s=DET_BS / step, peak_mib=peak,
               profiled_step_ms=wall, busy_ms=busy, busy_share=busy / wall,
               busy_of_median_step=busy / (step * 1e3),
               net_fwd_ms=under["det.net"],
               multibox_fwd_ms=under["det.multibox"],
               multibox_share=under["det.multibox"] / max(busy, 1e-9))
    log(f"detector step Resnet18 224² bs {DET_BS}: {step * 1e3:.2f} ms/step "
        f"(median of steps 5-{DET_TIMED_STEPS}), {DET_BS / step:.1f} imgs/s, "
        f"peak {peak:.0f} MiB; a profiled step: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}% of that wall, "
        f"{100 * busy / (step * 1e3):.1f}% of the median step), net forward "
        f"{under['det.net']:.2f} ms, matching + loss forward "
        f"{under['det.multibox']:.2f} ms ({100 * row['multibox_share']:.1f}% "
        "of busy)")
    return row


def phase_detector_train(tmp):
    """Path 10: phases 41-44."""
    tiny = phase_det_card_vs_cpu()
    k1, main_path = phase_det_main_path(tmp)
    conv = phase_det_convergence()
    speed = phase_det_speed()
    torch.cuda.empty_cache()
    return k1, dict(card_vs_cpu=tiny, main_path=main_path,
                    convergence=conv, speed=speed)


# ------------------------------------- path 11: HiFaceGAN

HIFACE_TRAIN = "configs/options/train/HiFaceGAN/train_hifacegan.yml"
HIFACE_TEST = "configs/options/test/HiFaceGAN/test_hifacegan.yml"
HIFACE_TEST_WOGT = "configs/options/test/HiFaceGAN/test_hifacegan_woGT.yml"
HIFACE_ITERS = 32
HIFACE_PAIRS = 8
HIFACE_SIZE = 512            # the config's gt_size; batch 1


def write_face_pairs(root, n, seed, size=HIFACE_SIZE):
    """n seeded size² GT scenes under root/gt and their ×4 round trip
    (area down, cubic up: the config's sr4x LQ) under root/lq."""
    import cv2
    for sub in ("gt", "lq"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    for i in range(n):
        gt = np.ascontiguousarray(scene_image(size, size, seed + i)[..., ::-1])
        lq = cv2.resize(cv2.resize(gt, (size // 4, size // 4),
                                   interpolation=cv2.INTER_AREA),
                        (size, size), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(f"{root}/gt/face_{i:02d}.png", gt)
        cv2.imwrite(f"{root}/lq/face_{i:02d}.png", lq)


def hiface_tiny_opt(root):
    """HiFaceGANModel at num_feat 8 (D 8) on 64² with two VGG taps, lsgan
    and feature matching: the pieces compared card vs CPU."""
    return {"is_train": True, "manual_seed": 0, "scale": 1,
            "model_type": "HiFaceGANModel", "path": {"models": root},
            "network_g": {"type": "HiFaceGAN", "num_feat": 8,
                          "is_train": False},
            "network_d": {"type": "HiFaceGANDiscriminator", "num_feat": 8},
            "train": {"optim_g": {"type": "Adam", "lr": 2e-4},
                      "optim_d": {"type": "Adam", "lr": 2e-4},
                      "perceptual_opt": {
                          "type": "PerceptualLoss",
                          "layer_weights": {"relu1_1": 0.5, "relu2_1": 1.0},
                          "use_input_norm": False,
                          "perceptual_weight": 10.0},
                      "gan_opt": {"type": "MultiScaleGANLoss",
                                  "gan_type": "lsgan"},
                      "feature_matching_opt": {"type": "GANFeatLoss",
                                               "loss_weight": 10.0}}}


def _hiface_pieces(model, lq, gt):
    """({loss: value}, {G parameter: grad}, {D parameter: grad}) of the G
    losses (D taking no gradient) and then the D losses at the detached
    output."""
    model.net_d.requires_grad_(False)
    total, losses, out, _ = model.g_losses(lq, gt)
    total.backward()
    model.net_d.requires_grad_(True)
    l_d, parts = model._gan_d_losses(out.detach(), gt)
    l_d.backward()
    losses = {k: float(v.detach()) for k, v in
              dict(losses, l_d=l_d, **parts).items()}
    grads = [{k: p.grad.detach().double().cpu()
              for k, p in net.named_parameters() if p.grad is not None}
             for net in (model.net_g, model.net_d)]
    return losses, *grads


def phase_hiface_card_vs_cpu(root):
    """Phase 45: the tiny HiFaceGAN's G losses (perceptual, multi-scale
    lsgan, feature matching) and D losses with G's and D's gradients, on
    the card and on the CPU in float32 from the same weights and batch,
    and on the CPU in float64, TF32 off: losses within 1e-5 relative of
    the CPU (D's mean logits 1e-5 absolute); gradients within 1e-4 of
    max|grad| of the CPU, or, where float32 itself cannot hold them (the
    LIP encoder's exp(12·sigmoid) weights and instance norms down to 2²
    put the CPU's own float32 gradients ≈4e-3 of max|grad| from float64),
    the card's gradients within PATH_F64_FACTOR times the CPU float32's
    distance from float64, plus 1e-4, as phase 35 holds the path term."""
    from image_restoration_tpu_torch.models import build_model
    old = _tf32_off()
    try:
        opt = hiface_tiny_opt(root)
        g = torch.Generator().manual_seed(4600)
        lq, gt = (torch.rand((2, 64, 64, 3), generator=g) for _ in range(2))
        models = {}
        for side, dev in (("cpu", "cpu"), ("card", "cuda"), ("f64", "cpu")):
            m = build_model(opt, device=dev)
            if side != "cpu":
                for name in ("net_g", "net_d"):
                    getattr(m, name).load_state_dict(
                        getattr(models["cpu"], name).state_dict())
            if side == "f64":
                for net in (m.net_g, m.net_d, m.cri_perceptual.vgg):
                    net.double()
            models[side] = m
        dt = {"cpu": torch.float32, "card": torch.float32,
              "f64": torch.float64}
        pieces = {side: _hiface_pieces(m, lq.to(m.device, dt[side]),
                                       gt.to(m.device, dt[side]))
                  for side, m in models.items()}
    finally:
        _tf32_restore(old)
    want, got = pieces["cpu"][0], pieces["card"][0]
    loss_err = max(abs(got[k] - v) / (1.0 if k.endswith("_score")
                                      else abs(v))
                   for k, v in want.items())

    def grad_err(a, b):
        scale = max(float(v.abs().max()) for v in b.values())
        return max(float((a[k] - v).abs().max()) for k, v in b.items()) \
            / scale

    rows = {}
    for i, name in ((1, "net_g"), (2, "net_d")):
        rows[name] = dict(
            card_vs_cpu=grad_err(pieces["card"][i], pieces["cpu"][i]),
            card_vs_f64=grad_err(pieces["card"][i], pieces["f64"][i]),
            cpu_vs_f64=grad_err(pieces["cpu"][i], pieces["f64"][i]))
    log(f"HiFaceGAN tiny pieces card vs CPU (TF32 off): losses "
        f"{sorted(want)} within {loss_err:.3g}; gradients of max|grad| "
        "(card vs CPU, card vs float64, CPU float32 vs float64): " + "; ".join(
            f"{n} " + "/".join(f"{v:.3g}" for v in r.values())
            for n, r in rows.items()))
    require(loss_err <= LOSS_RTOL, f"HiFaceGAN losses {loss_err}")
    for name, r in rows.items():
        require(r["card_vs_cpu"] <= GRAD_TOL or r["card_vs_f64"] <=
                PATH_F64_FACTOR * r["cpu_vs_f64"] + GRAD_TOL,
                f"HiFaceGAN {name} gradients {r}")
    return dict(loss_err=loss_err, grad_err=rows)


def phase_hiface_main_path(root):
    """Phase 46, main path: counts at 0; `train_pipeline` on
    train_hifacegan.yml as written (HiFaceGAN num_feat 48 at 512², the
    multi-scale D at 64, VGG19 perceptual to relu5_1, lsgan, ×10 feature
    matching, Adam, bs 1) with its train and val roots pointed at 8 seeded
    512² pairs, cut to 32 steps (a checkpoint and validation at the end);
    then test.py with test_hifacegan.yml and test_hifacegan_woGT.yml on
    the run's net_g_32.pth. Counts read: no port kernel on this path."""
    from image_restoration_tpu_torch.test import test_pipeline
    from image_restoration_tpu_torch.train import train_pipeline
    write_face_pairs(f"{root}/pairs", HIFACE_PAIRS, 4700)
    data = f"{root}/pairs"
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=[
        "-opt", HIFACE_TRAIN, "--force_yml",
        f"datasets:train:dataroot_gt={data}/gt",
        f"datasets:train:dataroot_lq={data}/lq",
        f"datasets:val:dataroot_gt={data}/gt",
        f"datasets:val:dataroot_lq={data}/lq",
        f"train:total_iter={HIFACE_ITERS}", "logger:print_freq=8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logs = model.log_dict
    require(model.iter == HIFACE_ITERS and model.cri_feat is not None
            and {"l_g_percep", "l_g_gan", "l_d"} <= set(logs)
            and all(math.isfinite(v) for v in logs.values()),
            f"HiFaceGAN training: iter {model.iter}, losses {logs}")
    ckpt = os.path.join(model.opt["path"]["models"],
                        f"net_g_{HIFACE_ITERS}.pth")
    t1 = time.perf_counter()
    with_gt = test_pipeline(root, argv=[
        "-opt", HIFACE_TEST, "--force_yml",
        f"datasets:test_gt:dataroot_gt={data}/gt",
        f"datasets:test_gt:dataroot_lq={data}/lq",
        f"path:pretrain_network_g={ckpt}"])
    wild = test_pipeline(root, argv=[
        "-opt", HIFACE_TEST_WOGT, "--force_yml",
        f"datasets:test_wild:dataroot_lq={data}/lq",
        f"path:pretrain_network_g={ckpt}"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = [k.launches for k in kernels]
    m = with_gt.get("FFHQ_sr4x_val", {})
    vis = [len(os.listdir(f"{root}/results/{n}/visualization"))
           for n in ("HiFaceGAN_SR4x_test", "HiFaceGAN_generic_test")]
    log(f"HiFaceGAN train_pipeline: {model.iter} iterations in {wall:.2f} s "
        "(wall: build, validation and saves included), last losses "
        + ", ".join(f"{k}={v:.4g}" for k, v in logs.items())
        + f"; test.py (2 configs) in {t2 - t1:.2f} s: {with_gt}, {wild}, "
        f"{vis} images written; K1/K2/K3 launches {counts}; random weights, "
        "random VGG taps and synthetic data: not a quality number")
    require(counts == [0, 0, 0], f"HiFaceGAN path: kernels {counts}")
    require(math.isfinite(m.get("psnr", float("nan")))
            and -1 <= m.get("ssim", 2) <= 1, f"test.py metrics {with_gt}")
    require(vis == [HIFACE_PAIRS, HIFACE_PAIRS], f"test.py images {vis}")
    return model, dict(train_wall_s=wall, last_losses=logs,
                       test_wall_s=t2 - t1, test_metrics=with_gt,
                       test_wild=wild)


def phase_hiface_speed(model, root):
    """Phase 47: s per step at the config's full width (median of steps
    5-16 of a loop with no synchronize between steps, on two 512² pairs
    from disk), imgs/s, peak MiB, and a profiled step's device-busy
    share."""
    import cv2
    data = f"{root}/pairs"
    batches = []
    for i in range(2):
        rd = [cv2.imread(f"{data}/{s}/face_{i:02d}.png")[..., ::-1]
              for s in ("lq", "gt")]
        batches.append({k: (v[None].astype(np.float32) / 255.0).copy()
                        for k, v in zip(("lq", "gt"), rd)})
    times, peak = comp_timed_steps(model, batches, TIMED_STEPS)
    step = float(np.median(times[4:]))
    wall, busy, _, kernels = comp_step_profile(
        lambda: model.optimize_parameters(model.iter + 1, batches[0]), {})
    top = [(round(k[0], 3), k[2][:60]) for k in kernels[:5]]
    row = dict(s_per_step=step, imgs_per_s=1 / step, peak_mib=peak,
               profiled_step_ms=wall, busy_ms=busy, busy_share=busy / wall,
               busy_of_median_step=busy / (step * 1e3), top_kernels=top)
    log(f"HiFaceGAN step at 512², bs 1: {step * 1e3:.2f} ms/step (median of "
        f"steps 5-{TIMED_STEPS}), {1 / step:.2f} imgs/s, peak {peak:.0f} "
        f"MiB; a profiled step: wall {wall:.2f} ms, device busy {busy:.2f} "
        f"ms ({100 * busy / wall:.1f}% of that wall, "
        f"{100 * busy / (step * 1e3):.1f}% of the median step); top kernels "
        f"{top}")
    return row


def phase_hifacegan(tmp):
    """Path 11: phases 45-47."""
    tiny = phase_hiface_card_vs_cpu(tmp)
    model, main_path = phase_hiface_main_path(tmp)
    speed = phase_hiface_speed(model, tmp)
    del model
    torch.cuda.empty_cache()
    return dict(card_vs_cpu=tiny, main_path=main_path, speed=speed)


# ------- path 12: the IO backends and the metrics (lmdb → train → FID)

FID_IMAGES = 2304            # > 2048: the 2048-d covariances have full rank
FID_ITERS = 16               # R1 at 16, the path step every 4
FID_G_BS = 16                # calculate_stylegan2_fid's batch
FID_STATS_BS = 64
FID_TRUNCATION = 0.7
K1_FID = 8 + (FID_IMAGES // FID_G_BS) * K1_PER_SG2_G[1]  # mean_latent + G
IO_CHECK_ITEMS = 64          # FFHQDataset items compared across backends
# images read per timed loader run; bs 3 cut to make room for path 14
IO_SPEED_IMAGES = {64: 128}
INCEPTION_TOL = 1e-4         # of max|CPU|, card vs CPU features, TF32 off
LPIPS_RTOL = 1e-4            # card vs CPU distance, TF32 off
G_SAMPLE_TOL = 1e-5          # of max|y|, the G sample on K1 vs plain K1
FID_ZERO_TOL = 1e-3          # |FID| of equal statistics, × trace(sigma)
RESIZE_TOL = 1e-6            # of max|f|, Inception's own resize vs JAX's two
METRIC_PAIRS = 16


def write_fid_images(folder, n, seed):
    """`n` seeded 256² scenes as PNGs at compression level 1, the level
    `make_lmdb_from_imgs` encodes at, so the lmdb holds the files' bytes;
    drawn and encoded on a thread pool."""
    import concurrent.futures
    import cv2
    os.makedirs(folder, exist_ok=True)
    names = [f"{i:05d}.png" for i in range(n)]

    def write(i):
        require(cv2.imwrite(os.path.join(folder, names[i]),
                            scene_image(256, 256, seed + i),
                            [cv2.IMWRITE_PNG_COMPRESSION, 1]),
                f"cannot write {names[i]}")

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n)))
    return names


def loader_rate(ds, bs, n_images):
    """Images/s through `ds` and the port's DataLoader (one reader thread,
    shuffled as training reads), host clock over `n_images`."""
    from image_restoration_tpu_torch.data import DataLoader
    loader = DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True)
    t0 = time.perf_counter()
    seen = 0
    for batch in loader:
        seen += batch["gt"].shape[0]
        if seen >= n_images:
            break
    return seen / (time.perf_counter() - t0)


def phase_fid_io(root):
    """Phase 48: 2304 seeded 256² PNGs; an lmdb by `make_lmdb_from_imgs`
    and a pak by the `create_pak` CLI; every key read back bit-equal to
    the PNG's bytes through FileClient("lmdb"), "pak" (the native reader)
    and "disk"; FFHQDataset items equal across the three backends; images/s
    through FFHQDataset and the DataLoader at bs 64 per backend."""
    from image_restoration_tpu_torch.data import build_dataset
    from image_restoration_tpu_torch.scripts import create_pak
    from image_restoration_tpu_torch.utils.file_client import FileClient
    from image_restoration_tpu_torch.utils.lmdb_util import \
        make_lmdb_from_imgs
    src, db, pak = f"{root}/ffhq", f"{root}/ffhq_256.lmdb", \
        f"{root}/ffhq_256.pak"
    t0 = time.perf_counter()
    names = write_fid_images(src, FID_IMAGES, 4800)
    t1 = time.perf_counter()
    make_lmdb_from_imgs(src, db, names, [n[:-4] for n in names])
    t2 = time.perf_counter()
    require(create_pak.main(["--input", src, "--output", pak])
            == FID_IMAGES, "create_pak packed another count")
    t3 = time.perf_counter()
    clients = {"lmdb": FileClient("lmdb", db_paths=db),
               "pak": FileClient("pak", pak_path=pak),
               "disk": FileClient("disk")}
    require(clients["pak"]._client.reader == "native",
            f"pak reader {clients['pak']._client.reader}, not native")
    keys = {"lmdb": lambda n: n[:-4], "pak": lambda n: n,
            "disk": lambda n: os.path.join(src, n)}
    read_s = {}
    for name, client in clients.items():
        t = time.perf_counter()
        for n in names:
            with open(os.path.join(src, n), "rb") as f:
                want = f.read()
            require(client.get(keys[name](n)) == want,
                    f"{name}: {n} differs from the PNG's bytes")
        read_s[name] = time.perf_counter() - t
    for c in clients.values():
        c.close()
    roots = {"lmdb": db, "pak": pak, "disk": src}
    datasets = {b: build_dataset(dict(
        type="FFHQDataset", dataroot_gt=r, io_backend={"type": b},
        use_hflip=False, mean=[0.5] * 3, std=[0.5] * 3))
        for b, r in roots.items()}
    for i in range(IO_CHECK_ITEMS):
        items = [ds[i]["gt"] for ds in datasets.values()]
        require(all(np.array_equal(items[0], x) for x in items[1:]),
                f"FFHQDataset item {i} differs across the backends")
    rates = {b: {bs: loader_rate(ds, bs, n)
                 for bs, n in IO_SPEED_IMAGES.items()}
             for b, ds in datasets.items()}
    log(f"IO: {FID_IMAGES} PNGs of 256² written in {t1 - t0:.2f} s, "
        f"lmdb built in {t2 - t1:.2f} s ({os.path.getsize(db + '/data.mdb')}"
        f" bytes), pak in {t3 - t2:.2f} s; every key bit-equal to its PNG "
        "through lmdb, pak (native reader) and disk ("
        + ", ".join(f"{b} {s:.2f} s" for b, s in read_s.items())
        + f"); {IO_CHECK_ITEMS} FFHQDataset items equal across backends")
    for b, r in rates.items():
        log(f"  FFHQDataset + DataLoader on {b}: "
            + ", ".join(f"bs {bs} {v:.1f} imgs/s" for bs, v in r.items()))
    return dict(src=src, lmdb=db, pak=pak, write_s=t1 - t0,
                lmdb_build_s=t2 - t1, pak_build_s=t3 - t2,
                read_all_keys_s=read_s, loader_imgs_per_s={
                    b: {str(bs): v for bs, v in r.items()}
                    for b, r in rates.items()})


def fid_generator(seed):
    """A StyleGAN2 generator at the StyleGAN2 config's 256² width
    (`calculate_stylegan2_fid`'s build) on the card, every parameter
    drawn."""
    from image_restoration_tpu_torch.archs import build_network
    net = build_network(dict(type="StyleGAN2OCRGenerator", input_width=256,
                             input_height=256, num_style_feat=512, num_mlp=8,
                             channel_multiplier=2),
                        torch.Generator().manual_seed(seed))
    randomize_weights(net, seed)
    return net.cuda().eval().requires_grad_(False)


def _read_rgb(folder, names):
    import cv2
    return np.stack([cv2.imread(os.path.join(folder, n))[..., ::-1]
                     for n in names]).astype(np.float32) / 255.0


def phase_fid_card_vs_cpu(io):
    """Phase 49, TF32 off: InceptionV3 features of 4 of the PNGs at 299²
    (≤ INCEPTION_TOL of max|CPU|), the LPIPS VGG16 distance of 4 pairs at
    256² (≤ LPIPS_RTOL relative), `calculate_fid` of the card's features
    against the CPU's (≈ 0 against trace(sigma)), card against CPU; and a
    bs-16 G sample at 256² through `calculate_stylegan2_fid.sample` on K1
    against the same on K1's plain version (≤ G_SAMPLE_TOL of max|y|, K1
    21 launches); that sample's features through InceptionV3's own 299²
    resize against JAX's path, which resizes in the script first
    (≤ RESIZE_TOL of max|f|)."""
    from image_restoration_tpu_torch.metrics.fid import (
        calculate_fid, extract_inception_features, load_patched_inception_v3)
    from image_restoration_tpu_torch.metrics.lpips import LPIPS
    from image_restoration_tpu_torch.ops import fused_act
    from image_restoration_tpu_torch.ops.resize import resize
    from image_restoration_tpu_torch.scripts.calculate_stylegan2_fid import \
        sample
    names = sorted(os.listdir(io["src"]))[:8]
    imgs = _read_rgb(io["src"], names)
    old = _tf32_off()
    try:
        feats = {}
        for dev in ("cpu", "cuda"):
            net = load_patched_inception_v3(device=dev)
            feats[dev] = extract_inception_features([imgs[:4]], net)
        d_inc = float(np.abs(feats["cuda"] - feats["cpu"]).max())
        span = float(np.abs(feats["cpu"]).max())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lp_cpu, lp_card = LPIPS(), LPIPS().cuda()
        a, b = torch.from_numpy(imgs[:4] * 2 - 1), torch.from_numpy(
            imgs[4:] * 2 - 1)
        with torch.inference_mode():
            d_cpu = lp_cpu(a, b).numpy()
            d_card = lp_card(a.cuda(), b.cuda()).cpu().numpy()
        d_lp = float(np.abs(d_card / d_cpu - 1).max())
        sig_cpu = np.cov(feats["cpu"], rowvar=False)
        fid = calculate_fid(feats["cuda"].mean(0),
                            np.cov(feats["cuda"], rowvar=False),
                            feats["cpu"].mean(0), sig_cpu)
        net = fid_generator(49)
        g = torch.Generator("cuda").manual_seed(49)
        z = torch.randn((FID_G_BS, 512), generator=g, device="cuda")
        with torch.inference_mode():
            mean = net.mean_latent(4096, g)
            fused_act.fused_leaky_relu.launches = 0
            y_k1 = sample(net, z, FID_TRUNCATION, mean)
            torch.cuda.synchronize()
            k1 = fused_act.fused_leaky_relu.launches
            with mock.patch.object(fused_act, "fused_leaky_relu",
                                   fused_act.fused_leaky_relu_plain):
                y_plain = sample(net, z, FID_TRUNCATION, mean)
            inc = load_patched_inception_v3(device="cuda")
            f_own = inc(y_k1)
            f_two = inc(resize(y_k1, (299, 299), "bilinear"))
        d_g = float((y_k1 - y_plain).abs().max())
        g_span = float(y_plain.abs().max())
        d_rs = float((f_own - f_two).abs().max())
        f_span = float(f_two.abs().max())
    finally:
        _tf32_restore(old)
    log(f"card vs CPU (TF32 off): InceptionV3 at 299² on 4 images max|d| "
        f"{d_inc:.3g} of max|CPU| {span:.4g} (≤ {INCEPTION_TOL:g}·max); "
        f"LPIPS on 4 pairs at 256² {d_card.tolist()} vs {d_cpu.tolist()}, "
        f"worst relative {d_lp:.3g} (≤ {LPIPS_RTOL:g}); FID(card features, "
        f"CPU features) {fid:.6g} against trace(sigma) "
        f"{np.trace(sig_cpu):.6g}; bs-16 G sample at 256² on K1 vs plain K1 "
        f"max|d| {d_g:.3g} of max|y| {g_span:.4g} (≤ {G_SAMPLE_TOL:g}·max), "
        f"K1 {k1} launches; its features through Inception's own resize "
        f"vs resized first (JAX's path) max|d| {d_rs:.3g} of max|f| "
        f"{f_span:.4g} (≤ {RESIZE_TOL:g}·max)")
    require(d_inc <= INCEPTION_TOL * span, f"InceptionV3 card vs CPU {d_inc}")
    require(d_lp <= LPIPS_RTOL, f"LPIPS card vs CPU {d_lp}")
    require(abs(fid) <= FID_ZERO_TOL * np.trace(sig_cpu),
            f"FID of the card's features against the CPU's {fid}")
    require(y_k1.shape == (FID_G_BS, 256, 256, 3)
            and bool(torch.isfinite(y_k1).all()), "G sample not finite")
    require(d_g <= G_SAMPLE_TOL * g_span, f"G sample K1 vs plain {d_g}")
    require(k1 == K1_PER_SG2_G[1], f"G sample: K1 {k1}")
    require(d_rs <= RESIZE_TOL * f_span, f"one resize vs two {d_rs}")
    return dict(inception_max_abs_diff=d_inc, inception_span=span,
                lpips_card=d_card.tolist(), lpips_cpu=d_cpu.tolist(),
                lpips_worst_rel=d_lp, fid_card_vs_cpu=fid,
                g_sample_max_abs_diff=d_g, g_sample_span=g_span, k1=k1,
                resize_max_abs_diff=d_rs, feature_span=f_span)


def phase_fid_main_path(root, io):
    """Phase 50, the main path: counts at 0; `train_pipeline` on the
    StyleGAN2 config as written, its lmdb backend included, cut to
    `dataroot_gt` = the phase-48 lmdb and 16 iterations with a checkpoint
    at 16; `calculate_fid_stats_from_datasets --io_backend lmdb` over the
    2304 images; `calculate_stylegan2_fid` of net_g_16.pth against those
    statistics (2304 samples, bs 16, truncation 0.7); `calculate_fid_folder`
    of the source PNGs against them (≈ 0: the same images at the same
    scale). Counts read: K1 exactly the 16 steps' G and D forwards from the
    model's own draws plus 8 + 144·21 for the FID; K2 and K3 never."""
    from image_restoration_tpu_torch.scripts import (
        calculate_fid_folder, calculate_fid_stats_from_datasets,
        calculate_stylegan2_fid)
    from image_restoration_tpu_torch.train import train_pipeline
    argv = ["-opt", SG2_CONFIG, "--force_yml",
            f"datasets:train:dataroot_gt={io['lmdb']}",
            f"train:total_iter={FID_ITERS}",
            f"logger:save_checkpoint_freq={FID_ITERS}", "logger:print_freq=8"]
    log("path 12 cuts (--force_yml): " + " ".join(argv[3:]))
    stats = f"{root}/inception_FFHQ_256.npz"
    kernels = _counts_zero()
    t0 = time.perf_counter()
    model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    calculate_fid_stats_from_datasets.main([
        "--dataroot", io["lmdb"], "--io_backend", "lmdb", "--size", "256",
        "--num_sample", str(FID_IMAGES), "--batch_size", str(FID_STATS_BS),
        "--save_path", stats])
    t2 = time.perf_counter()
    ckpt = os.path.join(model.opt["path"]["models"], f"net_g_{FID_ITERS}.pth")
    fid = calculate_stylegan2_fid.main([
        ckpt, stats, "--num_sample", str(FID_IMAGES), "--batch_size",
        str(FID_G_BS), "--truncation", str(FID_TRUNCATION)])
    t3 = time.perf_counter()
    fid_src = calculate_fid_folder.main(["--folder", io["src"],
                                         "--fid_stats", stats])
    t4 = time.perf_counter()
    k1, k2, k3 = (k.launches for k in kernels)
    io_opt = model.opt["datasets"]["train"]["io_backend"]
    draws = dict(model.style_draws)
    n_r1 = FID_ITERS // model.net_d_reg_every
    g_fwd = sum(c * K1_PER_SG2_G[n] for (_, n), c in draws.items())
    train_k1 = g_fwd + (FID_ITERS * 3 + n_r1) * K1_PER_SG2_D
    want = train_k1 + K1_FID
    with np.load(stats) as f:
        trace = float(np.trace(f["cov"]))
        n_stats = int(f["size"])
    log(f"StyleGAN2 config as written (io_backend {io_opt}): {FID_ITERS} "
        f"iterations in {t1 - t0:.2f} s (wall: build and saves included), "
        "last losses " + ", ".join(f"{k}={v:.4g}" for k, v in
                                   model.log_dict.items()))
    log(f"FID stats over the lmdb ({FID_IMAGES} images, bs {FID_STATS_BS}) "
        f"in {t2 - t1:.2f} s; calculate_stylegan2_fid of net_g_{FID_ITERS}"
        f".pth: FID {fid:.4f} in {t3 - t2:.2f} s ({FID_IMAGES} samples, bs "
        f"{FID_G_BS}, truncation {FID_TRUNCATION}; random Inception weights: "
        "not comparable to published FID); calculate_fid_folder of the "
        f"source PNGs against the lmdb stats: FID {fid_src:.6g} beside "
        f"trace(sigma) {trace:.6g}, in {t4 - t3:.2f} s")
    log(f"K1 expected = Σ draws × (21 one code, 29 two) + (3·{FID_ITERS} + "
        f"{n_r1} R1) D forwards × {K1_PER_SG2_D} = {train_k1}, + FID 8 + "
        f"{FID_IMAGES // FID_G_BS}·21 = {K1_FID}: {want}; K1 {k1}, K2 {k2}, "
        f"K3 {k3}")
    require(io_opt == {"type": "lmdb"}, f"io_backend {io_opt}")
    require(model.iter == FID_ITERS and all(
        math.isfinite(v) for v in model.log_dict.values()),
        f"training: iter {model.iter}, losses {model.log_dict}")
    require(n_stats == 256 and math.isfinite(fid) and math.isfinite(fid_src),
            f"FIDs {fid}, {fid_src}")
    require(abs(fid_src) <= FID_ZERO_TOL * trace,
            f"FID of the source folder against its own lmdb stats {fid_src} "
            f"(trace {trace}): the two paths feed Inception other scales")
    require(k1 == want, f"path 12: K1 {k1}, expected {want}")
    require(k2 == 0 and k3 == 0, f"path 12 launched K2 {k2} or K3 {k3}")
    return ckpt, dict(train_s=t1 - t0, stats_s=t2 - t1, fid_s=t3 - t2,
                      folder_fid_s=t4 - t3, fid=fid, folder_fid=fid_src,
                      trace_sigma=trace, k1=k1, k1_expected=want,
                      k1_training=train_k1, k1_fid=K1_FID,
                      last_losses=model.log_dict)


def phase_fid_clis_and_speed(root, io, ckpt, fid_s):
    """Phase 51: the LPIPS, NIQE and PSNR/SSIM CLIs on 16 pairs (the PNGs
    and noisy copies); G samples/s at bs 16 and Inception images/s at bs 64
    (CUDA events over host-issued calls, launch path included, PyTorch's
    default TF32 settings) beside phase 50's FID wall (`fid_s`); the device-busy share
    of one profiled sample + extract batch at bs 16."""
    import cv2
    from torch.profiler import ProfilerActivity, profile
    from image_restoration_tpu_torch.metrics.fid import \
        load_patched_inception_v3
    from image_restoration_tpu_torch.scripts import (
        calculate_lpips, calculate_niqe_folder, calculate_psnr_ssim)
    from image_restoration_tpu_torch.scripts.calculate_stylegan2_fid import (
        build_generator, sample)
    gt, out = f"{root}/pairs/gt", f"{root}/pairs/out"
    os.makedirs(gt)
    os.makedirs(out)
    rng = np.random.default_rng(51)
    for n in sorted(os.listdir(io["src"]))[:METRIC_PAIRS]:
        img = cv2.imread(os.path.join(io["src"], n))
        cv2.imwrite(os.path.join(gt, n), img)
        cv2.imwrite(os.path.join(out, n), np.clip(
            img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lp = calculate_lpips.main(["--gt", gt, "--restored", out])
    t1 = time.perf_counter()
    niqe = calculate_niqe_folder.main(["--input", out])
    t2 = time.perf_counter()
    psnr, ssim = calculate_psnr_ssim.main(["--gt", gt, "--restored", out])
    t3 = time.perf_counter()
    require(all(math.isfinite(v) for v in (lp, niqe, psnr, ssim)),
            f"metric CLIs: {lp}, {niqe}, {psnr}, {ssim}")

    net = build_generator(ckpt, 256, 2, "cuda")
    extract = load_patched_inception_v3(device="cuda")
    g = torch.Generator("cuda").manual_seed(51)
    zs = [(torch.randn((FID_G_BS, 512), generator=g, device="cuda"),)
          for _ in range(4)]
    x64 = [(torch.rand((64, 256, 256, 3), generator=g, device="cuda"),)
           for _ in range(2)]
    with torch.inference_mode():
        mean = net.mean_latent(4096, g)
        g_ms = host_time_ms(lambda z: sample(net, z, FID_TRUNCATION, mean),
                            zs, 10)
        inc_ms = host_time_ms(extract, x64, 5)
        batch = zs[0][0]
        for _ in range(3):
            extract(sample(net, batch, FID_TRUNCATION, mean))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t4 = time.perf_counter()
            extract(sample(net, batch, FID_TRUNCATION, mean))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t4) * 1e3
    kernels = _kernel_events(prof)
    busy = sum(k[0] for k in kernels)
    log(f"metric CLIs on {METRIC_PAIRS} pairs of 256²: LPIPS {lp:.6f} "
        f"({t1 - t0:.2f} s, random VGG16 and uniform lin weights: not "
        f"calibrated), NIQE {niqe:.4f} ({t2 - t1:.2f} s, host), PSNR "
        f"{psnr:.4f} dB SSIM {ssim:.4f} ({t3 - t2:.2f} s, host)")
    log(f"G sample at bs {FID_G_BS} (256², truncation {FID_TRUNCATION}, "
        f"[0, 1] at 256²): {g_ms:.3f} ms, {FID_G_BS / g_ms * 1e3:.1f} "
        f"samples/s; InceptionV3 at bs 64 (256² → 299²): {inc_ms:.3f} ms, "
        f"{64 / inc_ms * 1e3:.1f} images/s; calculate_stylegan2_fid's wall "
        f"for {FID_IMAGES} samples {fid_s:.2f} s; one sample + extract batch "
        f"profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%)")
    for t, n, name in kernels[:6]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    return dict(lpips=lp, niqe=niqe, psnr=psnr, ssim=ssim,
                lpips_cli_s=t1 - t0, niqe_cli_s=t2 - t1,
                psnr_ssim_cli_s=t3 - t2, g_sample_ms_bs16=g_ms,
                g_samples_per_s=FID_G_BS / g_ms * 1e3,
                inception_ms_bs64=inc_ms,
                inception_imgs_per_s=64 / inc_ms * 1e3,
                profiled_wall_ms=wall, profiled_busy_ms=busy,
                busy_share=busy / wall,
                top=[dict(ms=t, count=n, name=name[:160])
                     for t, n, name in kernels[:10]])


def phase_fid(tmp):
    """Path 12: phases 48-51."""
    io = phase_fid_io(tmp)
    check = phase_fid_card_vs_cpu(io)
    ckpt, main_path = phase_fid_main_path(tmp, io)
    speed = phase_fid_clis_and_speed(tmp, io, ckpt, main_path["fid_s"])
    torch.cuda.empty_cache()
    return main_path["k1"], dict(io={k: v for k, v in io.items()
                                     if k not in ("src", "lmdb", "pak")},
                                 card_vs_cpu=check, main_path=main_path,
                                 speed=speed)


# ------- path 13: the image zoo and the data preparation that feeds it

ZOO_PHOTOS = 8               # DIV2K-size photos; the first ZOO_TEST are the test sets
ZOO_TEST = 1                 # test-set images; 4 before path 14, 2 before 15
ZOO_HW = (1356, 2040)        # DIV2K's 2040×1356, a multiple of 12
ZOO_ITERS = 8
ZOO_TIMED = ("EDSR-L x4", "RCAN x2")  # phase 55; the others cut for path 14
ZOO_BS = 16                  # every zoo train config's batch_size_per_gpu
# BasicSR's DIV2K sub-image crops and steps, HR and each LR scale
ZOO_SUB = {1: (480, 240), 2: (240, 120), 3: (160, 80), 4: (120, 60)}
ZOO_TOL = 1e-4               # of max|CPU|, card vs CPU forwards, TF32 off
IMRESIZE_TOL = 1e-5          # of max|CPU|, imresize card vs CPU
ZOO_LR = 48                  # the LR batch of phase 53: 2 × 48²
ZOO_DATA = "datasets"        # under the path's temp dir, the configs' layout
ZOO_TRAIN = {
    "EDSR-L x4": ("configs/options/train/EDSR/train_EDSR_Lx4.yml", 4),
    "RCAN x2": ("configs/options/train/RCAN/train_RCAN_x2.yml", 2),
    "MSRResNet x4": ("configs/options/train/SRResNet_SRGAN/"
                     "train_MSRResNet_x4.yml", 4),
    "MSRGAN x4": ("configs/options/train/SRResNet_SRGAN/"
                  "train_MSRGAN_x4.yml", 4),
}
ZOO_TEST_CFG = {
    "EDSR-L x4": "configs/options/test/EDSR/test_EDSR_Lx4.yml",
    "RCAN x4": "configs/options/test/RCAN/test_RCAN.yml",
    "MSRResNet x4": "configs/options/test/SRResNet_SRGAN/"
                    "test_MSRResNet_x4.yml",
    "MSRResNet x4 woGT": "configs/options/test/SRResNet_SRGAN/"
                         "test_MSRResNet_x4_woGT.yml",
}
# each arch at its config's width (the EDSR, RCAN and SRResNet_SRGAN
# option files; RIDNet's defaults, BasicSR's denoising setting)
ZOO_ARCHS = {
    "EDSR-L x4": dict(type="EDSR", num_feat=256, num_block=32, upscale=4,
                      res_scale=0.1),
    "EDSR-M x3": dict(type="EDSR", num_feat=64, num_block=16, upscale=3),
    "RCAN 10x20 x4": dict(type="RCAN", num_feat=64, num_group=10,
                          num_block=20, squeeze_factor=16, upscale=4),
    "MSRResNet x2": dict(type="MSRResNet", num_feat=64, num_block=16,
                         upscale=2),
    "MSRResNet x3": dict(type="MSRResNet", num_feat=64, num_block=16,
                         upscale=3),
    "MSRResNet x4": dict(type="MSRResNet", num_feat=64, num_block=16,
                         upscale=4),
    "RIDNet": dict(type="RIDNet", in_channels=3, mid_channels=64,
                   out_channels=3, num_block=4),
}
# DFDNet at 512²: the reference's part sizes (80, 80, 50, 110 pixels) as
# boxes; the nose overlaps both eyes; K seeded atoms per part and tap,
# each of the part's size at that tap
DFD_BOXES = np.array([[150, 200, 230, 280], [280, 200, 360, 280],
                      [220, 250, 290, 320], [200, 330, 310, 440]])
DFD_PART_PX = (80, 80, 50, 110)
DFD_K = 64
DFD_TIMED = 10


def zoo_dict(seed):
    """A seeded dictionary in the reference's layout: {'256': {part:
    (K, C, s, s)}}, s = the part's size at the tap (40/40/25/55 at 256)."""
    from image_restoration_tpu_torch.archs.dfdnet_arch import (
        CHANNEL_SIZES, FEATURE_SIZES, PARTS)
    g = torch.Generator().manual_seed(seed)
    return {str(f): {p: torch.rand((DFD_K, c, px * f // 512, px * f // 512),
                                   generator=g)
                     for p, px in zip(PARTS, DFD_PART_PX)}
            for f, c in zip(FEATURE_SIZES, CHANNEL_SIZES)}


def phase_zoo_data(root):
    """Phase 52: 8 seeded 2040×1356 photos as DIV2K_train_HR (0001.png…);
    on the card, `generate_bicubic` (mod 12) writes each ×2/×3/×4 LR under
    DIV2K_train_LR_bicubic/X{s} named the DIV2K way (0001x4.png), and for
    the first ZOO_TEST the test sets Set5/GTmod12 and LRbicx{2,3,4} (and the
    DIV2K_valid pair, LR named 0001x4.png); `extract_subimages` cuts HR at
    480/240 and each LR at 240/120, 160/80, 120/60. Checks: 40 sub-images
    per image and scale, each GT sub-image's LQ partner present under the
    configs' `filename_tmpl: '{}'`; `imresize` card vs CPU within 1e-5 of
    max|CPU| and the LR PNGs written from the card within one level of the
    CPU's, at each scale."""
    import cv2
    from image_restoration_tpu_torch.ops.resize import imresize
    from image_restoration_tpu_torch.scripts import extract_subimages as sub
    from image_restoration_tpu_torch.scripts import matlab_scripts as mat
    d = f"{root}/{ZOO_DATA}"
    hr = f"{d}/DIV2K/DIV2K_train_HR"
    test_src = f"{d}/DIV2K/DIV2K_valid_HR_full"
    for folder in (hr, test_src):
        os.makedirs(folder)
    h, w = ZOO_HW
    for i in range(ZOO_PHOTOS):
        img = np.ascontiguousarray(scene_image(h, w, 5200 + i)[..., ::-1])
        cv2.imwrite(f"{hr}/{i + 1:04d}.png", img)
        if i < ZOO_TEST:
            cv2.imwrite(f"{test_src}/{i + 1:04d}.png", img)
    t0 = time.perf_counter()
    for s in (2, 3, 4):
        lr = f"{d}/DIV2K/DIV2K_train_LR_bicubic/X{s}"
        with contextlib.redirect_stdout(io.StringIO()):  # a line per image
            mat.generate_bicubic(hr, None, lr, None, 12, s)
            mat.generate_bicubic(test_src, f"{d}/Set5/GTmod12" if s == 2
                                 else None, f"{d}/Set5/LRbicx{s}", None, 12,
                                 s)
        for f in os.listdir(lr):
            os.rename(f"{lr}/{f}", f"{lr}/{f[:-4]}x{s}.png")
    x4 = f"{d}/DIV2K/DIV2K_valid_LR_bicubic/X4"
    os.makedirs(x4)
    for f in os.listdir(f"{d}/Set5/LRbicx4"):
        shutil.copyfile(f"{d}/Set5/LRbicx4/{f}", f"{x4}/{f[:-4]}x4.png")
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = {1: sub.extract_subimages(hr, f"{hr}_sub", *ZOO_SUB[1])}
    for s in (2, 3, 4):
        lr = f"{d}/DIV2K/DIV2K_train_LR_bicubic/X{s}"
        counts[s] = sub.extract_subimages(lr, f"{lr}_sub", *ZOO_SUB[s])
    t_sub = time.perf_counter() - t0
    gt_names = sorted(os.listdir(f"{hr}_sub"))
    missing = {s: sum(not os.path.exists(
        f"{d}/DIV2K/DIV2K_train_LR_bicubic/X{s}_sub/{n}") for n in gt_names)
        for s in (2, 3, 4)}
    log(f"zoo data: {ZOO_PHOTOS} photos {w}×{h}; generate_bicubic on the "
        f"card (LR ×2/×3/×4 of 8, GTmod12 + LRbicx2/3/4 of {ZOO_TEST}) in "
        f"{t_gen:.2f} s; extract_subimages in {t_sub:.2f} s: {counts} "
        f"sub-images (HR, X2, X3, X4); GT sub-images without an LQ partner "
        f"under '{{}}': {missing}")
    require(all(n == 40 * ZOO_PHOTOS for n in counts.values()),
            f"sub-image counts {counts}")
    require(not any(missing.values()), f"unpaired sub-images {missing}")
    img = torch.from_numpy(cv2.imread(f"{test_src}/0001.png").astype(
        np.float32) / 255.0)
    rows = {}
    for s in (2, 3, 4):
        cpu = imresize(img, 1.0 / s)
        card = imresize(img.cuda(), 1.0 / s).cpu()
        err = float((card - cpu).abs().max() / cpu.abs().max())
        png = cv2.imread(f"{d}/Set5/LRbicx{s}/0001.png").astype(np.int16)
        lvl = int(np.abs(png - mat.to_uint8(cpu).astype(np.int16)).max())
        ms = host_time_ms(lambda x: imresize(x, 1.0 / s),
                          [(img.cuda(),)], 20)
        rows[f"x{s}"] = dict(rel_err=err, png_levels=lvl, shape=list(
            cpu.shape), card_ms=ms)
        require(err <= IMRESIZE_TOL and lvl <= 1,
                f"imresize ×1/{s}: card vs CPU {err}, PNG {lvl} levels")
    log("zoo imresize card vs CPU (the 2040×1356 photo): " + "; ".join(
        f"{k} {v['shape']} {v['rel_err']:.3g} of max|CPU|, PNG "
        f"{v['png_levels']} level(s), {v['card_ms']:.3f} ms on the card"
        for k, v in rows.items()))
    return dict(root=d, generate_s=t_gen, extract_s=t_sub,
                sub_images=counts, imresize=rows)


def _lr_batch(seed, n=2, hw=ZOO_LR):
    """(n, hw, hw, 3) RGB float [0, 1] crops of seeded scenes."""
    return torch.from_numpy(np.stack([
        scene_image(hw, hw, seed + i) for i in range(n)]).astype(
            np.float32) / 255.0)


def _zoo_tiny_opt(root):
    """SRModel with a narrow EDSR ×4 (16 features, 2 blocks, res_scale
    0.1), L1, Adam: the tiny step held card vs CPU."""
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "scale": 4, "name": "tiny_edsr", "model_type": "SRModel",
            "path": {"models": f"{root}/tiny_edsr", "visualization": root},
            "network_g": {"type": "EDSR", "num_feat": 16, "num_block": 2,
                          "upscale": 4, "res_scale": 0.1},
            "train": {"optim_g": {"type": "Adam", "lr": 1e-4,
                                  "betas": [0.9, 0.99]},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "ema_decay": 0.999}}


def phase_zoo_card_vs_cpu(root):
    """Phase 53 (TF32 off): each arch at its config's full width on a 2 ×
    48² LR batch (RIDNet on the same ×255), card against CPU within 1e-4
    of max|CPU|; DFDNet (64 features, VGG19) at 512² with the four part
    boxes and a seeded K = 64 dictionary; and a tiny SRModel EDSR step's
    losses (1e-5 relative) and gradients (1e-4 of max|grad|)."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.convert import load_dfdnet_dict
    from image_restoration_tpu_torch.models import build_model
    rows = {}
    old = _tf32_off()
    try:
        x = _lr_batch(5300)
        for i, (name, opt) in enumerate(ZOO_ARCHS.items()):
            net = build_network(opt, torch.Generator().manual_seed(530 + i))
            randomize_weights(net, 531 + i)
            xi = x * 255.0 if opt["type"] == "RIDNet" else x
            t0 = time.perf_counter()
            with torch.inference_mode():
                cpu = net(xi)
            t_cpu = time.perf_counter() - t0
            with torch.inference_mode():
                card = net.cuda()(xi.cuda()).cpu()
            err = float((card - cpu).abs().max() / cpu.abs().max())
            rows[name] = dict(rel_err=err, out=list(cpu.shape),
                              cpu_s=t_cpu)
            del net
        net = build_network(dict(type="DFDNet"),
                            torch.Generator().manual_seed(540))
        randomize_weights(net, 541)
        face = torch.from_numpy(scene_image(512, 512, 5400)[None].astype(
            np.float32) / 127.5 - 1.0)
        ref_dict = zoo_dict(542)
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu = net(face, DFD_BOXES, load_dfdnet_dict(ref_dict, "cpu"))
        t_cpu = time.perf_counter() - t0
        with torch.inference_mode():
            card = net.cuda()(face.cuda(), DFD_BOXES,
                              load_dfdnet_dict(ref_dict, "cuda")).cpu()
        err = float((card - cpu).abs().max() / cpu.abs().max())
        rows["DFDNet 512²"] = dict(rel_err=err, out=list(cpu.shape),
                                   cpu_s=t_cpu, K=DFD_K, atoms={
                                       f: [list(v.shape[2:]) for v in
                                           parts.values()]
                                       for f, parts in ref_dict.items()})
        del net
        opt = _zoo_tiny_opt(root)
        cpu_m = build_model(opt, device="cpu")
        card_m = build_model(opt, device="cuda")
        randomize_weights(cpu_m.net_g, 550)
        card_m.net_g.load_state_dict(cpu_m.net_g.state_dict())
        g = torch.Generator().manual_seed(55)
        lq = torch.rand((2, 16, 16, 3), generator=g)
        gt = torch.rand((2, 64, 64, 3), generator=g)
        want, _ = sr_pieces(cpu_m, lq, gt)
        got, _ = sr_pieces(card_m, lq.cuda(), gt.cuda())
        rows["tiny EDSR SRModel step"] = compare_pieces(
            got, want, "zoo tiny EDSR step, card vs CPU (TF32 off)")
    finally:
        _tf32_restore(old)
    log("zoo archs card vs CPU (TF32 off, random weights), of max|CPU|: "
        + "; ".join(f"{k} {v['out']} {v['rel_err']:.3g} (CPU "
                    f"{v['cpu_s']:.2f} s)" for k, v in rows.items()
                    if "rel_err" in v)
        + f"; DFDNet dictionary K={DFD_K}, atoms (h, w) per tap and part "
        f"{rows['DFDNet 512²']['atoms']}")
    for k, v in rows.items():
        if "rel_err" in v:
            require(v["rel_err"] <= ZOO_TOL, f"{k}: card vs CPU {v}")
    return rows


def _record_validation(store):
    """Wrap SRModel.validation (SRGANModel inherits it) so that every
    result it returns is kept in `store`."""
    from image_restoration_tpu_torch.models.sr_model import SRModel
    orig = SRModel.validation

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(out)
        return out

    return mock.patch.object(SRModel, "validation", wrapped)


def phase_zoo_main_path(root, data):
    """Phase 54, main path: counts at 0; `train_pipeline` for 8 steps on
    train_EDSR_Lx4.yml (bs 16, gt 192), train_RCAN_x2.yml (bs 16, gt 96,
    `network_g:upscale=2`: the file ships upscale 4 at scale 2, which fails
    at the first loss, as under JAX), train_MSRResNet_x4.yml and
    train_MSRGAN_x4.yml (random VGG19 taps), each as written apart from
    its dataroots (the made sub-images, validation on the made Set5) and
    `pretrain_network_g` (absent), a checkpoint and a validation at 8;
    then test.py: test_EDSR_Lx4.yml on EDSR-L's net_g_8.pth,
    test_MSRResNet_x4.yml and its _woGT twin on MSRResNet's, and
    test_RCAN.yml (×4) on a seeded RCAN ×4 reference-layout `.pth` (the
    trained RCAN is ×2), each set pointed at the made folders (DIV2K100
    through its `'{}x4'` on DIV2K-named LR); RIDNet and DFDNet at 512²
    from reference-layout `.pth` files written here (DFDNet's with its
    spectral-norm triples, beside its dictionary `.pth`). Every PSNR
    finite; K1, K2 and K3 counted 0."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.convert import (
        dfdnet_reference_state_dict, load_dfdnet, load_dfdnet_dict)
    from image_restoration_tpu_torch.convert.pth import load_pth
    from image_restoration_tpu_torch.test import test_pipeline
    from image_restoration_tpu_torch.train import train_pipeline
    d = data["root"]
    set5 = f"{d}/Set5"
    kernels = _counts_zero()
    models, train_rows, vals = {}, {}, []
    for name, (cfg, s) in ZOO_TRAIN.items():
        argv = ["-opt", cfg, "--force_yml",
                f"datasets:train:dataroot_gt={d}/DIV2K/DIV2K_train_HR_sub",
                f"datasets:train:dataroot_lq={d}/DIV2K/"
                f"DIV2K_train_LR_bicubic/X{s}_sub",
                f"datasets:val:dataroot_gt={set5}/GTmod12",
                f"datasets:val:dataroot_lq={set5}/LRbicx{s}",
                "path:pretrain_network_g=~", f"train:total_iter={ZOO_ITERS}",
                "logger:print_freq=8"]
        if name == "RCAN x2":
            argv.append("network_g:upscale=2")
        t0 = time.perf_counter()
        with _record_validation(vals):
            model = train_pipeline(root, argv=argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logs, val = model.log_dict, vals[-1]
        ckpt = os.path.join(model.opt["path"]["models"],
                            f"net_g_{ZOO_ITERS}.pth")
        train_rows[name] = dict(wall_s=wall, last_losses=logs, val=val,
                                ckpt=ckpt)
        log(f"zoo {name}: {model.iter} iterations in {wall:.2f} s (wall: "
            "build, validation on 4 2040×1356 images and saves included); "
            "last losses " + ", ".join(f"{k}={v:.4g}"
                                       for k, v in logs.items())
            + f"; validation {val}")
        pix = logs.get("l_pix", logs.get("l_g_pix"))
        require(model.iter == ZOO_ITERS and os.path.exists(ckpt)
                and all(math.isfinite(v) for v in logs.values())
                and pix < 100.0  # an L1 of [0, 1] images: not diverged
                and math.isfinite(val.get("psnr", float("nan"))),
                f"zoo {name}: iter {model.iter}, {logs}, {val}")
        models[name] = model
    rcan4 = build_network(dict(ZOO_ARCHS["RCAN 10x20 x4"]),
                          torch.Generator().manual_seed(560))
    pths = {"EDSR-L x4": train_rows["EDSR-L x4"]["ckpt"],
            "RCAN x4": save_pth(rcan4, f"{root}/RCAN_BIX4.pth"),
            "MSRResNet x4": train_rows["MSRResNet x4"]["ckpt"],
            "MSRResNet x4 woGT": train_rows["MSRResNet x4"]["ckpt"]}
    del rcan4
    test_rows = {}
    for name, cfg in ZOO_TEST_CFG.items():
        if name.endswith("woGT"):
            sets = [f"datasets:test_1:dataroot_lq={set5}/LRbicx4",
                    f"datasets:test_2:dataroot_lq={set5}/LRbicx4"]
        else:
            sets = [f"datasets:test_{i}:dataroot_gt={set5}/GTmod12"
                    for i in (1, 2, 3)] + [
                f"datasets:test_1:dataroot_lq={set5}/LRbicx4",
                f"datasets:test_2:dataroot_lq={set5}/LRbicx4",
                f"datasets:test_3:dataroot_lq={d}/DIV2K/"
                "DIV2K_valid_LR_bicubic/X4"]
        t0 = time.perf_counter()
        res = test_pipeline(root, argv=["-opt", cfg, "--force_yml", *sets,
                                        f"path:pretrain_network_g="
                                        f"{pths[name]}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_img = ZOO_TEST * len(res)
        test_rows[name] = dict(wall_s=wall, images=n_img,
                               imgs_per_s=n_img / wall, metrics=res)
        log(f"zoo test.py {cfg}: {n_img} images (2040×1356 out) in "
            f"{wall:.2f} s ({n_img / wall:.2f} images/s, PSNR/SSIM on the "
            f"host and PNG writes included): {res}")
        require(all(math.isfinite(m["psnr"]) for m in res.values())
                if not name.endswith("woGT")
                else res == {"Set5": {}, "Set14": {}},
                f"zoo test.py {name}: {res}")
    # RIDNet and DFDNet from reference-layout .pth files
    rid_opt = ZOO_ARCHS["RIDNet"]
    rid = build_network(rid_opt, torch.Generator().manual_seed(570))
    randomize_weights(rid, 571)
    rid_pth = save_pth(rid, f"{root}/RIDNet.pth")
    rid_card = build_network(rid_opt).cuda().eval()
    rid_card.load_state_dict(load_pth(rid_pth, "params_ema"), strict=True)
    clean = scene_image(512, 512, 5700).astype(np.float32)
    noisy = np.clip(clean + np.random.default_rng(57).normal(
        0, 15, clean.shape), 0, 255).astype(np.float32)
    with torch.inference_mode():
        den = rid_card(torch.from_numpy(noisy[None]).cuda()).cpu()[0]
    rid_psnr = _psnr_u8(np.clip(den.numpy(), 0, 255).astype(np.uint8),
                        clean.astype(np.uint8))
    dfd = build_network(dict(type="DFDNet"),
                        torch.Generator().manual_seed(580))
    randomize_weights(dfd, 581)
    torch.save(dfdnet_reference_state_dict(dfd), f"{root}/DFDNet.pth")
    torch.save(zoo_dict(582), f"{root}/DFDNet_dict.pth")
    dfd_card = load_dfdnet(f"{root}/DFDNet.pth", build_network(
        dict(type="DFDNet"))).cuda().eval()
    ddict = load_dfdnet_dict(f"{root}/DFDNet_dict.pth")
    face = torch.from_numpy(scene_image(512, 512, 5800)[None].astype(
        np.float32) / 127.5 - 1.0).cuda()
    old = _tf32_off()
    try:  # the folded checkpoint gives the net it came from back
        with torch.inference_mode():
            restored = dfd_card(face, DFD_BOXES, ddict)
            twin = dfd.cuda().eval()(face, DFD_BOXES, ddict)
    finally:
        _tf32_restore(old)
    fold_err = float((restored - twin).abs().max() / twin.abs().max())
    restored_u8 = ((restored[0].cpu().numpy() + 1) * 127.5).clip(
        0, 255).astype(np.uint8)
    dfd_psnr = _psnr_u8(restored_u8, ((face[0].cpu().numpy() + 1) * 127.5)
                        .astype(np.uint8))
    counts = [k.launches for k in kernels]
    log(f"zoo RIDNet 512² from its .pth: PSNR {rid_psnr:.2f} dB against the "
        f"clean photo (σ=15 noise); DFDNet 512² from a spectral-norm .pth "
        f"and a K={DFD_K} dictionary .pth: PSNR {dfd_psnr:.2f} dB against "
        f"its input, the loaded net {fold_err:.3g} of max|y| from the net "
        f"it was written from (TF32 off); K1/K2/K3 launches {counts}; random weights "
        "and synthetic data: not quality numbers")
    require(counts == [0, 0, 0], f"zoo path: kernels {counts}")
    require(math.isfinite(rid_psnr) and math.isfinite(dfd_psnr)
            and fold_err <= 1e-5, f"RIDNet/DFDNet: {rid_psnr} {dfd_psnr} "
            f"{fold_err}")
    nets = dict(ridnet=(rid_card, torch.from_numpy(noisy[None]).cuda()),
                dfdnet=(dfd_card, face, ddict))
    del dfd, twin
    return models, nets, dict(
        train={k: {kk: vv for kk, vv in v.items() if kk != "ckpt"}
               for k, v in train_rows.items()},
        test=test_rows, ridnet_psnr=rid_psnr, dfdnet_psnr=dfd_psnr,
        dfdnet_fold_rel=fold_err, launches=counts)


def _zoo_batches(model, n=4):
    """n batches of the trainer's own train set (its loader's crops), as
    numpy, read before timing."""
    from image_restoration_tpu_torch.data import (build_dataloader,
                                                  build_dataset)
    opt = dict(model.opt["datasets"]["train"])
    loader = build_dataloader(build_dataset(opt), opt, seed=1)
    out = []
    for batch in loader:
        out.append({k: v for k, v in batch.items() if k in ("lq", "gt")})
        if len(out) == n:
            break
    return out


def phase_zoo_speed(models, nets):
    """Phase 55: for EDSR-L and RCAN (ZOO_TIMED) s per step (median of
    steps 5-8 of a loop with no synchronize between steps, on 4 pre-read
    batches of its own sub-images, bs 16), imgs/s and peak MiB; the
    device-busy share of one
    profiled step of EDSR-L and of RCAN; RIDNet's and DFDNet's ms per 512²
    forward (CUDA events, 10 forwards as the host issues them)."""
    rows = {}
    for name, model in models.items():
        if name not in ZOO_TIMED:  # a throughput repetition, cut
            models[name] = None
            del model
            continue
        batches = _zoo_batches(model)
        times, peak = timed_sr_steps(model, batches, ZOO_ITERS)
        step = float(np.median(times[4:]))
        row = dict(s_per_step=step, imgs_per_s=ZOO_BS / step, peak_mib=peak)
        if name in ("EDSR-L x4", "RCAN x2"):
            wall, busy = step_busy(model, batches[0])
            row.update(profiled_step_ms=wall, busy_ms=busy,
                       busy_share=busy / wall)
        rows[name] = row
        log(f"zoo {name} bs={ZOO_BS}: {step * 1e3:.2f} ms/step (median of "
            f"steps 5-{ZOO_ITERS}), {ZOO_BS / step:.2f} imgs/s, peak "
            f"{peak:.0f} MiB" + (
                f"; a profiled step: wall {row['profiled_step_ms']:.2f} ms, "
                f"device busy {row['busy_ms']:.2f} ms "
                f"({100 * row['busy_share']:.1f}%)"
                if "busy_share" in row else ""))
        models[name] = None
        del model
        torch.cuda.empty_cache()
    rid, rx = nets["ridnet"]
    dfd, fx, ddict = nets["dfdnet"]
    with torch.inference_mode():
        rid_ms = host_time_ms(rid, [(rx,)], DFD_TIMED)
        dfd_ms = host_time_ms(lambda x: dfd(x, DFD_BOXES, ddict), [(fx,)],
                              DFD_TIMED)
    rows["RIDNet 512²"] = dict(ms_per_forward=rid_ms)
    rows["DFDNet 512²"] = dict(ms_per_forward=dfd_ms)
    log(f"zoo forwards at 512², bs 1: RIDNet {rid_ms:.2f} ms, DFDNet "
        f"{dfd_ms:.2f} ms (K={DFD_K}, 16 part swaps)")
    return rows


def phase_zoo(tmp):
    """Path 13: phases 52-55."""
    t0 = time.perf_counter()
    data = phase_zoo_data(tmp)
    check = phase_zoo_card_vs_cpu(tmp)
    models, nets, main_path = phase_zoo_main_path(tmp, data)
    speed = phase_zoo_speed(models, nets)
    del models, nets
    torch.cuda.empty_cache()
    data = {k: v for k, v in data.items() if k != "root"}
    log(f"path 13: {time.perf_counter() - t0:.1f} s")
    return main_path["launches"], dict(data=data, card_vs_cpu=check,
                                       main_path=main_path, speed=speed)


# ------- path 14: video (EDVR, BasicVSR/IconVSR, DUF, TOFlow, the video
# datasets and trainers, VideoPipeline)

VID_CLIPS = ("001", "002", "003", "004")  # none of REDS4's 000/011/015/020
VID_FRAMES = 15              # BasicVSR's and IconVSR's training num_frame
VID_TEST_FRAMES = 5          # the test configs' clips, cut to 5 frames
VID_VAL_FRAMES = 5           # the trainers' validation clip
VID_HW = (720, 1280)         # REDS's GT; LQ ×1/4, 180×320
VID4_HW = (288, 352)         # the DUF / TOFlow test clip (Vid4-style)
VID_ITERS = 8
VID_CUT = 4                  # tsa_iter and fix_flow
# the trainers whose step is profiled: EDVR-L (the DCN on a device-bound
# step) and IconVSR (the DCN and the warps); a 15-frame recurrent step
# holds ≈ 60k trace events, which take the profiler 30-50 s to process
VID_PROFILED = ("EDVR-L",)   # IconVSR's profile cut for path 15
VID_TOL = 1e-4               # of max|CPU| (and of max|grad|), TF32 off
VID_TRAIN = {
    "EDVR-L": ("configs/options/train/EDVR/train_EDVR_L_x4_SR_REDS.yml",
               ["path:pretrain_network_g=~", f"train:tsa_iter={VID_CUT}"]),
    "BasicVSR": ("configs/options/train/BasicVSR/train_BasicVSR_REDS.yml",
                 ["network_g:spynet_path=~", f"train:fix_flow={VID_CUT}"]),
    "IconVSR": ("configs/options/train/BasicVSR/train_IconVSR_REDS.yml",
                ["network_g:spynet_path=~", "network_g:edvr_path=~",
                 f"train:fix_flow={VID_CUT}"]),
    "VideoRecurrentGAN": ("configs/options/train/VideoRecurrentGAN/"
                          "train_VideoRecurrentGANModel_REDS.yml",
                          ["network_g:spynet_path=~",
                           "path:pretrain_network_g=~"]),
}
# each arch at its config's width (the EDVR-L / EDVR-M, IconVSR, DUF and
# TOF option files), frames and LQ size of the card-vs-CPU check
VID_ARCHS = {
    "SpyNet": (dict(type="SpyNet"), None),
    "EDVR-L": (dict(type="EDVR", num_feat=128, num_frame=5,
                    deformable_groups=8, num_extract_block=5,
                    num_reconstruct_block=40), (5, 64, 64)),
    "EDVR-M": (dict(type="EDVR", num_feat=64, num_frame=5,
                    deformable_groups=8, num_extract_block=5,
                    num_reconstruct_block=10), (5, 64, 64)),
    "BasicVSR": (dict(type="BasicVSR", num_feat=64, num_block=30),
                 (5, 64, 64)),
    "IconVSR": (dict(type="IconVSR", num_feat=64, num_block=30,
                     keyframe_stride=5, temporal_padding=2), (5, 64, 64)),
    "DUF-52": (dict(type="DUF", scale=4, num_layer=52,
                    adapt_official_weights=True), (7, 64, 64)),
    "TOFlow": (dict(type="TOFlow", adapt_official_weights=True),
               (7, 64, 64)),
}
VID_VIDEO = dict(frames=48, hw=(480, 640), batch=4)


def _video_scene(seed, hw, frames, motion):
    """`frames` GT frames (uint8 RGB, on the card) of a seeded scene moving
    by `motion` = (Δx, Δy) px a frame, sub-pixel: each frame is the padded
    scene warped by t·motion (the port's flow_warp, border padding) and
    cropped."""
    from image_restoration_tpu_torch.archs.arch_util import flow_warp
    h, w = hw
    pad = int(math.ceil(max(abs(m) for m in motion) * frames)) + 4
    scene = torch.from_numpy(scene_image(h + 2 * pad, w + 2 * pad, seed)
                             .astype(np.float32)).cuda()[None]
    out = []
    for t in range(frames):
        flow = torch.tensor([motion[0] * t, motion[1] * t],
                            device="cuda").expand(1, h + 2 * pad,
                                                  w + 2 * pad, 2)
        f = flow_warp(scene, flow, padding_mode="border")
        out.append(f[0, pad:pad + h, pad:pad + w].round().clamp(0, 255)
                   .to(torch.uint8))
    return out


def _write_pngs(jobs):
    """cv2.imwrite of (path, RGB uint8 array) on 8 threads."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        path, img = job
        os.makedirs(os.path.dirname(path), exist_ok=True)
        require(cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1])),
                f"cannot write {path}")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))


def phase_video_data(root):
    """Phase 56: seeded synthetic clips on the card in REDS's layout: 4
    clips of 15 720×1280 GT frames (train_sharp/<clip>/<frame>.png), each
    a scene moving by its own sub-pixel motion, their ×1/4 LQ by the port's
    MATLAB-bicubic `imresize` (train_sharp_bicubic/X4); the meta-info list
    by `scripts/generate_meta_info.py reds --root`; the test clips (the 4
    clips cut to 10 frames), a 5-frame validation clip, a Vid4-style
    288×352 clip of 7 frames with its ×1/4 LQ and that LQ bicubic-upscaled
    (TOFlow's input), a Vimeo-style folder of 2 septuplets (256×448, LQ
    64×112) with its list; and a 640×480 mp4v video (MJPG .avi where cv2
    cannot write mp4v) of a car scene panning across 48 frames."""
    import cv2
    from image_restoration_tpu_torch.ops.resize import imresize
    from image_restoration_tpu_torch.scripts import (generate_meta_info,
                                                     regroup_reds_dataset)
    d = f"{root}/datasets"
    t0 = time.perf_counter()
    jobs = []

    def add_clip(gt_root, lq_root, up_root, name, frames):
        for i, f in enumerate(frames):
            lq = imresize(f.float()[None] / 255.0, 0.25)[0]
            lq_u8 = (lq * 255.0).round().clamp(0, 255).to(torch.uint8)
            jobs.append((f"{gt_root}/{name}/{i:08d}.png", f.cpu().numpy()))
            jobs.append((f"{lq_root}/{name}/{i:08d}.png",
                         lq_u8.cpu().numpy()))
            if up_root:
                up = cv2.resize(lq_u8.cpu().numpy(), (f.shape[1],
                                                      f.shape[0]),
                                interpolation=cv2.INTER_CUBIC)
                jobs.append((f"{up_root}/{name}/{i:08d}.png", up))

    reds = f"{d}/REDS"
    for k, clip in enumerate(VID_CLIPS):
        frames = _video_scene(5600 + k, VID_HW, VID_FRAMES,
                              (0.37 + 0.5 * k, -0.61 + 0.3 * k))
        add_clip(f"{reds}/train_sharp", f"{reds}/train_sharp_bicubic/X4",
                 None, clip, frames)
        add_clip(f"{reds}/test/GT", f"{reds}/test/X4", None, clip,
                 frames[:VID_TEST_FRAMES])
        if k == 0:
            add_clip(f"{reds}/val/GT", f"{reds}/val/X4", None, clip,
                     frames[:VID_VAL_FRAMES])
    add_clip(f"{d}/Vid4/GT", f"{d}/Vid4/BIx4", f"{d}/Vid4/BIx4up_direct",
             "calendar", _video_scene(5700, VID4_HW, 7, (0.8, 0.45)))
    vimeo = f"{d}/vimeo90k"
    for k, key in enumerate(("00001/0001", "00001/0002")):
        frames = _video_scene(5800 + k, (256, 448), 7, (0.5, 0.25))
        for i, f in enumerate(frames):
            lq = imresize(f.float()[None] / 255.0, 0.25)[0]
            jobs.append((f"{vimeo}/GT/{key}/im{i + 1}.png", f.cpu().numpy()))
            jobs.append((f"{vimeo}/BIx4/{key}/im{i + 1}.png",
                         (lq * 255.0).round().clamp(0, 255).to(torch.uint8)
                         .cpu().numpy()))
    _write_pngs(jobs)
    t_clips = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        meta = {"train": f"{d}/meta_REDS_GT.txt",
                "test": f"{d}/meta_REDS_test.txt",
                "val": f"{d}/meta_REDS_val.txt"}
        lines = {k: generate_meta_info.main(["reds", "--root", src,
                                              "--out", meta[k]])
                 for k, src in (("train", f"{reds}/train_sharp"),
                                ("test", f"{reds}/test/GT"),
                                ("val", f"{reds}/val/GT"))}
        with open(f"{d}/sep_testlist.txt", "w") as f:
            f.write("00001/0001\n00001/0002\n")
        meta["vimeo"] = f"{d}/meta_Vimeo90K_test.txt"
        generate_meta_info.main(["vimeo", "--list",
                                 f"{d}/sep_testlist.txt", "--out",
                                 meta["vimeo"]])
    require(lines["train"] == [f"{c} {VID_FRAMES} ({VID_HW[0]},{VID_HW[1]},3)"
                               for c in VID_CLIPS],
            f"meta-info: {lines['train']}")
    # the regroup script on a copy of one clip as REDS's val split
    os.makedirs(f"{d}/regroup/train")
    shutil.copytree(f"{reds}/val/X4/001", f"{d}/regroup/val/001")
    with contextlib.redirect_stdout(io.StringIO()):
        moved = regroup_reds_dataset.regroup_reds_dataset(
            f"{d}/regroup/train", f"{d}/regroup/val")
    require(moved == ["241"], f"regroup_reds_dataset: {moved}")

    # the video file: a car scene panning right and down, 48 frames
    vh, vw = VID_VIDEO["hw"]
    video = f"{root}/cars.mp4"
    frames = _video_scene(5900, (vh, vw), VID_VIDEO["frames"], (2.5, 1.25))
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (vw, vh))
    if not wr.isOpened():
        video = f"{root}/cars.avi"
        wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                             (vw, vh))
    for f in frames:
        wr.write(np.ascontiguousarray(f.cpu().numpy()[..., ::-1]))
    wr.release()
    cap = cv2.VideoCapture(video)
    n_read = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    require(n_read == VID_VIDEO["frames"], f"{video}: {n_read} frames")
    wall = time.perf_counter() - t0
    log(f"video data: {len(VID_CLIPS)} REDS-layout clips of {VID_FRAMES} "
        f"{VID_HW[1]}×{VID_HW[0]} GT frames with ×1/4 LQ (imresize on the "
        f"card), test clips of {VID_TEST_FRAMES}, a {VID_VAL_FRAMES}-frame "
        f"val clip, a Vid4-style {VID4_HW[1]}×{VID4_HW[0]} clip of 7, "
        f"2 Vimeo septuplets, {len(jobs)} PNGs in {t_clips:.2f} s; meta "
        f"lists by generate_meta_info; {os.path.basename(video)} "
        f"({vw}×{vh}, {n_read} frames); {wall:.2f} s in all")
    return dict(root=d, meta=meta, video=video, clips_s=t_clips,
                pngs=len(jobs), data_s=wall, video_frames=n_read)


def _rel_err(card, cpu):
    return float((card.float().cpu() - cpu.float()).abs().max()
                 / cpu.float().abs().max())


def phase_video_card_vs_cpu():
    """Phase 57 (TF32 off): the modulated deformable conv at EDVR-L's
    shapes (128 channels, 8 deformable groups, 3×3, offsets uniform in ±8
    px, a sigmoid mask) at 64² and 180×320 and `flow_warp` at BasicVSR's
    64 channels and 180×320 (flows uniform in ±8 px; zero and border
    padding): outputs within 1e-4 of max|CPU|, and the gradients of
    Σ out·c to every input within 1e-4 of max|grad| (on the card a
    gather's backward adds atomically, in no fixed order). Then each arch
    at its config's width, card against CPU within 1e-4 of max|CPU|:
    SpyNet on a 180×320 pair, EDVR-L, EDVR-M, BasicVSR and IconVSR on 5
    frames of 64², DUF-52 (official weights' BatchNorm, drawn statistics)
    and TOFlow on 7 frames of 64²."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.archs.arch_util import flow_warp
    from image_restoration_tpu_torch.ops.deform_conv import \
        modulated_deform_conv
    rows = {}
    old = _tf32_off()
    try:
        for h, w in ((64, 64), (180, 320)):
            g = torch.Generator().manual_seed(5700 + h)
            ins = [torch.randn(1, h, w, 128, generator=g),
                   torch.rand(1, h, w, 8 * 18, generator=g) * 16 - 8,
                   torch.sigmoid(torch.randn(1, h, w, 8 * 9, generator=g)),
                   torch.randn(128, 128, 3, 3, generator=g) * 0.03,
                   torch.randn(128, generator=g) * 0.1]
            c = torch.randn(1, h, w, 128, generator=g)

            def run(dev):
                xs = [t.detach().to(dev).requires_grad_(True) for t in ins]
                t0 = time.perf_counter()
                y = modulated_deform_conv(*xs, deformable_groups=8)
                (y * c.to(dev)).sum().backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                return y.detach(), [t.grad for t in xs], \
                    time.perf_counter() - t0

            y_cpu, g_cpu, t_cpu = run("cpu")
            y_card, g_card, _ = run("cuda")
            grads = {n: _rel_err(a, b) for n, a, b in zip(
                ("x", "offset", "mask", "weight", "bias"), g_card, g_cpu)}
            rows[f"DCN {h}×{w}"] = dict(out_rel=_rel_err(y_card, y_cpu),
                                        grad_rel=grads, cpu_s=t_cpu)
        g = torch.Generator().manual_seed(5710)
        x = torch.randn(2, 180, 320, 64, generator=g)
        flow = torch.rand(2, 180, 320, 2, generator=g) * 16 - 8
        c = torch.randn(2, 180, 320, 64, generator=g)
        for pad in ("zeros", "border"):
            res = {}
            for dev in ("cpu", "cuda"):
                xs = [t.detach().to(dev).requires_grad_(True)
                      for t in (x, flow)]
                y = flow_warp(*xs, padding_mode=pad)
                (y * c.to(dev)).sum().backward()
                res[dev] = (y.detach(), [t.grad for t in xs])
            rows[f"flow_warp 64ch 180×320 {pad}"] = dict(
                out_rel=_rel_err(res["cuda"][0], res["cpu"][0]),
                grad_rel={n: _rel_err(a, b) for n, a, b in zip(
                    ("x", "flow"), res["cuda"][1], res["cpu"][1])})
        for i, (name, (opt, shape)) in enumerate(VID_ARCHS.items()):
            net = build_network(opt, torch.Generator().manual_seed(571 + i))
            randomize_weights(net, 581 + i)
            g = torch.Generator().manual_seed(591 + i)
            if name == "DUF-52":  # drawn BatchNorm statistics
                with torch.no_grad():
                    for bn, b in net.named_buffers():
                        if bn.endswith("running_mean"):
                            b.copy_(0.1 * torch.randn(b.shape, generator=g))
                        elif bn.endswith("running_var"):
                            b.copy_(1 + 0.2 * torch.rand(b.shape,
                                                         generator=g))
            net.eval()
            if shape is None:
                args = [torch.rand(1, 180, 320, 3, generator=g)
                        for _ in range(2)]
            else:
                args = [torch.rand((1,) + shape + (3,), generator=g)]
            t0 = time.perf_counter()
            with torch.inference_mode():
                cpu = net(*args)
            t_cpu = time.perf_counter() - t0
            with torch.inference_mode():
                card = net.cuda()(*[a.cuda() for a in args])
            rows[name] = dict(out_rel=_rel_err(card, cpu),
                              out=list(cpu.shape), cpu_s=t_cpu)
            del net
    finally:
        _tf32_restore(old)
    log("video card vs CPU (TF32 off, random weights), of max|CPU| (grads "
        "of max|grad|): " + "; ".join(
            f"{k} {v['out_rel']:.3g}" + (
                " grads " + ", ".join(f"{n} {e:.3g}"
                                      for n, e in v["grad_rel"].items())
                if "grad_rel" in v else f" {v['out']}")
            + (f" (CPU {v['cpu_s']:.2f} s)" if "cpu_s" in v else "")
            for k, v in rows.items()))
    for k, v in rows.items():
        worst = max([v["out_rel"]] + list(v.get("grad_rel", {}).values()))
        require(worst <= VID_TOL, f"{k}: card vs CPU {v}")
    return rows


def _video_ranges():
    """Patches that run each DCN and flow_warp call of the video archs in
    the profiler ranges irt.dcn and irt.flow_warp."""
    from image_restoration_tpu_torch.archs import (basicvsr_arch, edvr_arch,
                                                   spynet_arch, tof_arch)
    return ([mock.patch.object(edvr_arch, "modulated_deform_conv", _ranged(
        "irt.dcn", edvr_arch.modulated_deform_conv))]
        + [mock.patch.object(m, "flow_warp", _ranged("irt.flow_warp",
                                                      m.flow_warp))
           for m in (basicvsr_arch, spynet_arch, tof_arch)])


def _video_step_profile(model, batch):
    """(wall ms, busy ms, {part: device ms}) of one profiled step: the DCN's
    and the warps' forwards (their ranges) and backwards (the autograd
    nodes of their gathers)."""
    from torch.profiler import ProfilerActivity, profile
    patches = _video_ranges()
    for p in patches:
        p.start()
    try:
        model.optimize_parameters(model.iter + 1, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.optimize_parameters(model.iter + 1, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    # one aggregation of the trace (a 15-frame recurrent step holds tens of
    # thousands of events; each key_averages() pass takes seconds)
    busy, cpu_ms, host = 0.0, {}, []
    for e in prof.key_averages():
        kind = getattr(e, "device_type", None)
        if kind == torch.autograd.DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        elif kind == torch.autograd.DeviceType.CPU:
            cpu_ms[e.key] = getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0.0)) / 1e3
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    ev = "autograd::engine::evaluate_function: "
    parts = {"dcn_forward": cpu_ms.get("irt.dcn", 0.0),
             "dcn_gather_backward": cpu_ms.get(ev + "IndexSelectBackward0",
                                               0.0),
             "warp_forward": cpu_ms.get("irt.flow_warp", 0.0),
             "warp_backward": cpu_ms.get(ev + "GridSampler2DBackward0", 0.0)}
    # where the host's time goes: the ops with the most self CPU time
    parts["host_top"] = [dict(ms=t, count=n, op=k[:80])
                         for t, n, k in sorted(host, reverse=True)[:6]]
    return wall, busy, parts


def _record_video_validation(store):
    """Wrap VideoBaseModel.validation so that every result it returns is
    kept in `store`."""
    from image_restoration_tpu_torch.models.video_models import \
        VideoBaseModel
    orig = VideoBaseModel.validation

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(out)
        return out

    return mock.patch.object(VideoBaseModel, "validation", wrapped)


def _first_batch(opt):
    from image_restoration_tpu_torch.data import (build_dataloader,
                                                  build_dataset)
    ds_opt = dict(opt["datasets"]["train"])
    for batch in build_dataloader(build_dataset(ds_opt), ds_opt, seed=2):
        return {k: v for k, v in batch.items() if k in ("lq", "gt")}


def phase_video_main_path(root, data):
    """Phase 58, main path: counts at 0; `train_pipeline` for 8 steps on
    train_EDVR_L_x4_SR_REDS.yml (bs 4, gt 256, 5 frames; `tsa_iter` 4),
    train_BasicVSR_REDS.yml and train_IconVSR_REDS.yml (bs 4, 15 frames;
    `fix_flow` 4) and train_VideoRecurrentGANModel_REDS.yml (bs 4, 15
    frames, VGG19 and a 256² D), each as written but for its dataroots and
    meta-info files, `spynet_path`/`edvr_path`/`pretrain_network_g` (no
    `.pth` here) and the iteration cuts, each logged. Checks: below
    `tsa_iter` only `fusion.*` moved; below `fix_flow` `spynet.*` and
    `edvr.*` stayed bit-unchanged; every loss finite; a validation PSNR.
    s per step is the median of steps 5-8 of the run itself (CUDA events
    after each step, no synchronize between), with clips/s, peak MiB, and
    one profiled step's busy share and DCN / warp shares (EDVR-L and
    IconVSR). Then test.py:
    test_EDVR_L_x4_SR_REDS.yml on EDVR-L's net_g_8.pth over the 4 clips
    cut to 5 frames, test_BasicVSR_REDS.yml (whole clips) on BasicVSR's,
    test_BasicVSR_Vimeo90K_BIx4.yml (flip_seq, center_frame_only) on the
    septuplets, test_DUF_official.yml (DUF's Gaussian downsampling of the
    GT on the host) and test_TOF_official.yml on seeded reference-layout
    `.pth` files over the Vid4-style clip: frames/s and PSNR."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.test import test_pipeline
    from image_restoration_tpu_torch.train import train_pipeline
    from image_restoration_tpu_torch.models import video_models
    d, meta = data["root"], data["meta"]
    reds = f"{d}/REDS"
    kernels = _counts_zero()
    rows, ckpts, vals = {}, {}, []
    for name, (cfg, cuts) in VID_TRAIN.items():
        argv = ["-opt", cfg, "--force_yml",
                f"datasets:train:dataroot_gt={reds}/train_sharp",
                f"datasets:train:dataroot_lq={reds}/train_sharp_bicubic/X4",
                f"datasets:train:meta_info_file={meta['train']}",
                f"datasets:val:dataroot_gt={reds}/val/GT",
                f"datasets:val:dataroot_lq={reds}/val/X4",
                f"datasets:val:meta_info_file={meta['val']}",
                f"train:total_iter={VID_ITERS}", "logger:print_freq=8",
                *cuts]
        log(f"video {name}: --force_yml cuts {cuts + [f'train:total_iter={VID_ITERS}']}"
            " (and the dataroots / meta-info files)")
        cls = getattr(video_models, {"EDVR-L": "EDVRModel",
                                     "VideoRecurrentGAN":
                                     "VideoRecurrentGANModel"}.get(
                                         name, "VideoRecurrentModel"))
        orig = cls.optimize_parameters
        rec = dict(events=[], snap=None, moved=None)

        def step(self, current_iter, batch, generator=None, rec=rec,
                 orig=orig):
            if current_iter == 1:
                rec["snap"] = {k: v.clone() for k, v in
                               self.net_g.state_dict().items()}
                rec["events"].append(torch.cuda.Event(enable_timing=True))
                rec["events"][-1].record()
            out = orig(self, current_iter, batch, generator)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["events"].append(ev)
            if current_iter == VID_CUT - 1 and rec["snap"] is not None:
                rec["moved"] = sorted(
                    k for k, v in self.net_g.state_dict().items()
                    if not torch.equal(v, rec["snap"][k]))
                rec["snap"] = None
            if current_iter == VID_ITERS:
                rec["peak"] = torch.cuda.max_memory_allocated() / 2 ** 20
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(cls, "optimize_parameters", step), \
                _record_video_validation(vals):
            model = train_pipeline(root, argv=argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = rec["events"]
        times = [a.elapsed_time(b) / 1e3 for a, b in zip(ev, ev[1:])]
        s_step = float(np.median(times[4:]))
        bs = model.opt["datasets"]["train"]["batch_size_per_gpu"]
        logs = model.log_dict
        val = vals[-1] if vals else {}
        ckpts[name] = os.path.join(model.opt["path"]["models"],
                                   f"net_g_{VID_ITERS}.pth")
        names = list(model.net_g.state_dict())
        moved = rec["moved"]
        cut = name != "VideoRecurrentGAN"
        if name == "EDVR-L":  # below tsa_iter only the TSA fusion trains
            require(moved and all(k.startswith("fusion.") for k in moved),
                    f"video {name}: moved below tsa_iter: {moved}")
        elif cut:  # below fix_flow SpyNet and the EDVR extractor stay
            require(moved and not any(k.startswith(("spynet.", "edvr."))
                                      for k in moved),
                    f"video {name}: moved below fix_flow: {moved}")
        prof = {}
        if name in VID_PROFILED:
            pwall, busy, parts = _video_step_profile(model,
                                                     _first_batch(model.opt))
            prof = dict(profiled_step_ms=pwall, busy_ms=busy,
                        busy_share=busy / pwall, parts_ms=parts,
                        parts_share={k: v / busy for k, v in parts.items()
                                     if k != "host_top"})
        rows[name] = dict(
            wall_s=wall, iters=model.iter, s_per_step=s_step,
            clips_per_s=bs / s_step, batch=bs, peak_mib=rec.get("peak"),
            last_losses=logs, validation=val,
            moved_below_cut=dict(count=len(moved), of=len(names))
            if cut else None, **prof)
        log(f"video {name}: {VID_ITERS} iterations in {wall:.2f} s (wall: "
            f"build and validation included); {s_step * 1e3:.2f} ms/step "
            f"(median of steps 5-{VID_ITERS}), {bs / s_step:.3f} clips/s at "
            f"bs {bs}, peak {rec.get('peak', float('nan')):.0f} MiB; last "
            "losses " + ", ".join(f"{k}={v:.4g}" for k, v in logs.items())
            + (f"; below the cut {len(moved)} of {len(names)} tensors "
               "moved, the frozen ones bit-unchanged" if cut else "")
            + f"; validation {val}" + (
                f"; a profiled step: wall {pwall:.2f} ms, busy {busy:.2f} "
                f"ms ({100 * busy / pwall:.1f}%), " + ", ".join(
                    f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
                    for k, v in parts.items() if k != "host_top")
                + "; host's top ops (self CPU ms, count): " + ", ".join(
                    f"{h['op']} {h['ms']:.1f} x{h['count']}"
                    for h in parts["host_top"]) if prof else ""))
        require(model.iter >= VID_ITERS and os.path.exists(ckpts[name])
                and logs and all(math.isfinite(v) for v in logs.values())
                and val and all(math.isfinite(v) for v in val.values()),
                f"video {name}: iter {model.iter}, {logs}, {val}")
        del model
        torch.cuda.empty_cache()

    # test.py
    duf = build_network(dict(type="DUF", scale=4, num_layer=52,
                             adapt_official_weights=True),
                        torch.Generator().manual_seed(590))
    tof = build_network(dict(type="TOFlow", adapt_official_weights=True),
                        torch.Generator().manual_seed(591))
    pths = {"DUF": save_pth(duf, f"{root}/DUF.pth"),
            "TOF": save_pth(tof, f"{root}/TOF.pth")}
    del duf, tof
    tests = {
        "EDVR-L REDS4": ("configs/options/test/EDVR/test_EDVR_L_x4_SR_REDS.yml",
                         ckpts["EDVR-L"], f"{reds}/test/GT",
                         f"{reds}/test/X4", meta["test"],
                         len(VID_CLIPS) * VID_TEST_FRAMES),
        "BasicVSR REDS4": ("configs/options/test/BasicVSR/"
                           "test_BasicVSR_REDS.yml", ckpts["BasicVSR"],
                           f"{reds}/test/GT", f"{reds}/test/X4", None,
                           len(VID_CLIPS) * VID_TEST_FRAMES),
        "BasicVSR Vimeo90K": ("configs/options/test/BasicVSR/"
                              "test_BasicVSR_Vimeo90K_BIx4.yml",
                              ckpts["BasicVSR"], f"{d}/vimeo90k/GT",
                              f"{d}/vimeo90k/BIx4", meta["vimeo"], 2),
        "DUF Vid4": ("configs/options/test/DUF/test_DUF_official.yml",
                     pths["DUF"], f"{d}/Vid4/GT", f"{d}/Vid4/BIx4", None, 7),
        "TOF Vid4": ("configs/options/test/TOF/test_TOF_official.yml",
                     pths["TOF"], f"{d}/Vid4/GT", f"{d}/Vid4/BIx4up_direct",
                     None, 7),
    }
    test_rows = {}
    for name, (cfg, pth, gt, lq, mi, frames) in tests.items():
        key = "test_1" if "BasicVSR" in name else "test"  # the files' keys
        sets = [f"datasets:{key}:dataroot_gt={gt}",
                f"datasets:{key}:dataroot_lq={lq}",
                f"datasets:{key}:meta_info_file={mi or '~'}"]
        if "BasicVSR" in name:  # its SpyNet comes with the checkpoint
            sets.append("network_g:spynet_path=~")
        t0 = time.perf_counter()
        res = test_pipeline(root, argv=["-opt", cfg, "--force_yml", *sets,
                                        f"path:pretrain_network_g={pth}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (metrics,) = res.values()
        test_rows[name] = dict(wall_s=wall, frames=frames,
                               frames_per_s=frames / wall, metrics=metrics)
        log(f"video test.py {cfg}: {frames} frames in {wall:.2f} s "
            f"({frames / wall:.2f} frames/s, build, PSNR on the host and "
            f"data included): {metrics}")
        require(metrics and all(math.isfinite(v) for v in metrics.values()),
                f"video test.py {name}: {res}")
    return rows, test_rows, kernels


def phase_video_pipeline(video, kernels):
    """Phase 59: `VideoPipeline` on the 640×480 video with the port's
    Resnet18 detector at 224² (calibrated statistics), batches of 4:
    frames/s, tracks, and the detector's share of the wall (its calls
    timed, a synchronize ending each); then K1, K2 and K3 must count 0 on
    the whole path."""
    from image_restoration_tpu_torch.serve.video import VideoPipeline
    det = build_detector("Resnet18", "cuda", seed=0)
    pipe = VideoPipeline(det, batch_size=VID_VIDEO["batch"])
    pipe.run(video, max_frames=VID_VIDEO["batch"])  # warm up
    pipe = VideoPipeline(det, batch_size=VID_VIDEO["batch"])
    det_s = [0.0]
    orig = pipe.detect_batch

    def timed(frames):
        t0 = time.perf_counter()
        out = orig(frames)
        det_s[0] += time.perf_counter() - t0
        return out

    pipe.detect_batch = timed
    out = f"{os.path.dirname(video)}/annotated.mp4"
    t0 = time.perf_counter()
    res = pipe.run(video, out)
    wall = time.perf_counter() - t0
    ids = {t.track_id for _, tracks in res for t in tracks}
    per_frame = [len(t) for _, t in res]
    counts = [k.launches for k in kernels]
    row = dict(frames=len(res), wall_s=wall, frames_per_s=len(res) / wall,
               tracks=len(ids), mean_tracks_per_frame=float(
                   np.mean(per_frame)), detector_s=det_s[0],
               detector_share=det_s[0] / wall, launches=counts)
    log(f"VideoPipeline: {len(res)} frames of {VID_VIDEO['hw'][1]}×"
        f"{VID_VIDEO['hw'][0]} in {wall:.2f} s ({len(res) / wall:.2f} "
        f"frames/s, batches of {VID_VIDEO['batch']}), {len(ids)} tracks, "
        f"{np.mean(per_frame):.2f} a frame, detector {det_s[0]:.2f} s "
        f"({100 * det_s[0] / wall:.1f}% of the wall: decode, tracking, "
        f"annotation and mp4v writing the rest); K1/K2/K3 launches on path "
        f"14 {counts}")
    require(len(res) == VID_VIDEO["frames"] and os.path.exists(out),
            f"VideoPipeline: {len(res)} frames")
    require(counts == [0, 0, 0], f"video path: kernels {counts}")
    return row


def phase_video(tmp):
    """Path 14: phases 56-59."""
    t0 = time.perf_counter()
    data = phase_video_data(tmp)
    check = phase_video_card_vs_cpu()
    train, test, kernels = phase_video_main_path(tmp, data)
    pipeline = phase_video_pipeline(data["video"], kernels)
    data = {k: v for k, v in data.items() if k not in ("root", "meta")}
    log(f"path 14: {time.perf_counter() - t0:.1f} s")
    return pipeline["launches"], dict(data=data, card_vs_cpu=check,
                                      train=train, test=test,
                                      pipeline=pipeline)


# ----------------------------- path 15: the last modules of the port

# each newly served arch at the width of the configs/ file that trains it
# (EDSR, RCAN, SRResNet_SRGAN, HiFaceGAN; RIDNet's defaults, BasicSR's
# denoising setting; GFPGANv1 at BasicSR's train_gfpgan_v1_512 options;
# SPADEGenerator at HiFaceGAN's), its normalization, and the side of its
# seeded input (the config's LR crop, or its image size)
P15_SPADE = dict(num_in_ch=3, num_feat=48, use_vae=False, z_dim=256,
                 crop_size=512, norm_g="spectralspadebatch3x3",
                 is_train=False)
P15_ARCHS = {
    "GFPGANv1 512": (dict(type="GFPGANv1", input_width=512,
                          input_height=512, num_style_feat=512,
                          channel_multiplier=1, num_mlp=8,
                          input_is_latent=True, different_w=True, narrow=1,
                          sft_half=True), {}, 512),
    "MSRResNet x4": (ZOO_ARCHS["MSRResNet x4"], "sr", 32),
    "EDSR-L x4": (ZOO_ARCHS["EDSR-L x4"], "sr", 48),
    "RCAN 10x20 x4": (ZOO_ARCHS["RCAN 10x20 x4"], "sr", 48),
    "RIDNet": (ZOO_ARCHS["RIDNet"], dict(mean=(0, 0, 0), std=(1 / 255,) * 3,
                                         out_min_max=(0, 255)), 128),
    "SPADEGenerator": (dict(type="SPADEGenerator", **P15_SPADE), {}, 512),
    "HiFaceGAN": (dict(type="HiFaceGAN", **P15_SPADE), {}, 512),
}
P15_TIMED = 10               # calls per arch at bs 1
P15_PHOTO = (768, 1024)      # EDSR-L ×4's tiled photo (H, W)
P15_TILE = dict(tile=256, halo=16, scale=4, tile_batch=4)
OCR_ITERS = 16               # R1 at 16; validation and a checkpoint at 16
OCR_MASK_PROB = 0.5          # the dataset's default mask_prob
HELPER_CROPS = 2             # detections the helper restores (keep_top_k)
WORLD1_GT = 4                # the world-of-one GAN step's batch (32²)


def _seeded_rgb(h, w, seed):
    """An RGB uint8 scene of h×w (scene_image is RGB)."""
    return np.ascontiguousarray(scene_image(h, w, seed))


def phase_restorer_archs():
    """Phase 60: a `Restorer` over each newly admitted arch at its config's
    width on a seeded input at its configured size: card vs CPU on
    `restore_batch_u8` (TF32 off, ≤1 LSB), ms per call at bs 1 (host
    clock around calls that end in the device→host copy, median of
    P15_TIMED, TF32 as PyTorch leaves it), and EDSR-L ×4's
    `restore_tiled_u8` on a 1024×768 photo."""
    from image_restoration_tpu_torch.infer import SR_MEAN_STD, Restorer
    rows = {}
    for i, (name, (opt, norm, size)) in enumerate(P15_ARCHS.items()):
        norm = SR_MEAN_STD if norm == "sr" else norm
        card = Restorer(opt, device="cuda", seed=600 + i, **norm)
        cpu = Restorer(opt, device="cpu", seed=600 + i, **norm)
        u8 = _seeded_rgb(size, size, 6000 + i)[None]
        old = _tf32_off()
        try:
            got = card.restore_batch_u8(u8)
        finally:
            _tf32_restore(old)
        t0 = time.perf_counter()
        want = cpu.restore_batch_u8(u8)
        cpu_s = time.perf_counter() - t0
        lsb = _lsb(got, want)
        times = []
        for _ in range(P15_TIMED + 2):
            t0 = time.perf_counter()
            card.restore_batch_u8(u8)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times[2:]))
        rows[name] = dict(input=size, output=list(got.shape[1:3]),
                          card_vs_cpu_lsb=lsb, ms_bs1=ms, cpu_s=cpu_s,
                          params=sum(p.numel() for p in card.net.parameters()))
        log(f"Restorer({opt['type']}) {name}: {size}² in -> "
            f"{got.shape[1]}×{got.shape[2]} out, card vs CPU max {lsb} LSB "
            f"(CPU {cpu_s:.2f} s), {ms:.3f} ms per restore_batch_u8 at bs 1")
        require(lsb <= 1, f"Restorer {name}: card vs CPU {lsb} LSB")
        if name == "EDSR-L x4":
            photo = _seeded_rgb(*P15_PHOTO, 6100)
            card.restore_tiled_u8(photo[:96, :96], **P15_TILE)  # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            big = card.restore_tiled_u8(photo, **P15_TILE)
            tiled_s = time.perf_counter() - t0
            want_hw = (P15_PHOTO[0] * 4, P15_PHOTO[1] * 4, 3)
            require(big.shape == want_hw and big.dtype == np.uint8,
                    f"EDSR-L tiled: {big.shape}")
            rows[name]["tiled_1024x768_s"] = tiled_s
            log(f"EDSR-L ×4 restore_tiled_u8 on a 1024×768 photo (tile "
                f"{P15_TILE['tile']}, halo {P15_TILE['halo']}, "
                f"{P15_TILE['tile_batch']} tiles a call): {tiled_s:.3f} s "
                f"-> {big.shape[1]}×{big.shape[0]}")
        del card, cpu
        torch.cuda.empty_cache()
    return rows


def phase_ocr_masks(root):
    """Phase 61: the mask apply halves on the card against the CPU at one
    set of drawn parameters (bs 16, 256²; bit-equal), then the main path:
    counts at 0, `train_pipeline` on configs/train_gfpgan_plate_256.yml
    with the train dataset's type overridden to OCRDegradationDataset and
    `random_mask: true` (OCR_ITERS steps at the config's bs 4, R1 at 16,
    validation and a checkpoint at 16); K1 exactly OCR_ITERS·84 + 15 + the
    validation forwards' 39 each; s per step (median of steps 5-16, CUDA
    events, no synchronize between) and the masked share of the batch."""
    from image_restoration_tpu_torch.data import masks as M
    from image_restoration_tpu_torch.data import pipelines
    from image_restoration_tpu_torch.data.degradations import params_to
    from image_restoration_tpu_torch.models.gfpgan_model import GFPGANModel
    from image_restoration_tpu_torch.train import train_pipeline
    g = torch.Generator().manual_seed(61)
    bank = torch.from_numpy(M.build_irregular_mask_bank(256))
    p = M.sample_random_mask(g, 16, bank.shape[0], OCR_MASK_PROB)
    img = torch.rand((16, 256, 256, 3), generator=g)
    pc = params_to(p, "cuda")
    checks = {
        "rect": (M.rect_masks(p["rect"], 256, 256),
                 M.rect_masks(pc["rect"], 256, 256)),
        "half": (M.half_mask(p["side"], 256, 256),
                 M.half_mask(pc["side"], 256, 256)),
    }
    cpu_out, cpu_mask = M.apply_random_mask(img, bank, p, fill=1.0)
    card_out, card_mask = M.apply_random_mask(img.cuda(), bank.cuda(), pc,
                                              fill=1.0)
    checks["mask"] = (cpu_mask, card_mask)
    checks["masked image"] = (cpu_out, card_out)
    for k, (a, b) in checks.items():
        require(torch.equal(a, b.cpu()), f"mask {k}: card and CPU differ")
    log(f"masks card vs CPU at the same draws (bs 16, 256²): "
        f"{', '.join(checks)} bit-equal; {int(p['do'].sum())} of 16 masked")

    write_plates(f"{root}/train", 8, 6110)
    write_plates(f"{root}/val", TRAIN_VAL_IMAGES, 6120)
    argv = ["-opt", TRAIN_CONFIG, "--force_yml",
            f"datasets:train:dataroot_gt={root}/train",
            f"datasets:val:dataroot_gt={root}/val",
            "datasets:train:type=OCRDegradationDataset",
            "datasets:train:random_mask=true",
            f"train:total_iter={OCR_ITERS}", f"val:val_freq={OCR_ITERS}",
            f"logger:save_checkpoint_freq={OCR_ITERS}", "logger:print_freq=8"]
    log(f"OCR-masked GAN: {TRAIN_CONFIG} with --force_yml "
        f"{' '.join(argv[3:])}")
    shares, in_step = [], [False]  # the training steps' masks (validation
    orig_mask = pipelines.apply_random_mask  # degrades with them too)

    def record_mask(img, bank, p, fill=1.0):
        out, mask = orig_mask(img, bank, p, fill)
        if in_step[0]:
            shares.append(mask.detach().mean(dim=(1, 2, 3)))
        return out, mask

    events = []
    orig_step = GFPGANModel.optimize_parameters

    def step(self, current_iter, batch, generator=None):
        if not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        in_step[0] = True
        out = orig_step(self, current_iter, batch, generator)
        in_step[0] = False
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    kernels = _counts_zero()
    t0 = time.perf_counter()
    with mock.patch.object(pipelines, "apply_random_mask", record_mask), \
            mock.patch.object(GFPGANModel, "optimize_parameters", step):
        model = train_pipeline(root, argv=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = (k.launches for k in kernels)
    want = (OCR_ITERS * K1_PER_GD_STEP + (OCR_ITERS // 16) * K1_PER_R1_STEP
            + 2 * TRAIN_VAL_IMAGES * K1_LAUNCHES_PER_FORWARD)
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    s_step = float(np.median(times[4:]))
    per = torch.cat(shares).cpu()
    masked = float((per > 0).float().mean())
    logs = model.log_dict
    log(f"OCR-masked GAN: {OCR_ITERS} iterations in {wall:.2f} s (wall, "
        f"build, validation and saves included), {s_step * 1e3:.2f} ms/step "
        f"(median of steps 5-{OCR_ITERS}), "
        f"{4 / s_step:.2f} imgs/s at bs 4; masked: {masked:.3f} of "
        f"{per.numel()} images (mask_prob {OCR_MASK_PROB}), "
        f"{float(per.mean()):.4f} of all pixels, "
        f"{float(per[per > 0].mean()):.4f} of a masked image's; K1 {k1} "
        f"(expected {want}), K2 {k2}, K3 {k3}; last losses "
        + ", ".join(f"{k}={v:.4g}" for k, v in logs.items()))
    require(type(model.degrade_fn).__name__ == "OCRDegradation",
            "the OCR pipeline did not run")
    require(per.numel() == OCR_ITERS * 4, f"{per.numel()} masked images")
    require(k1 == want, f"OCR main path: K1 {k1}, expected {want}")
    require(k2 == 0 and k3 == 0, "OCR main path launched K2 or K3")
    require(all(math.isfinite(v) for v in logs.values()), "a non-finite loss")
    require("l_d_r1" in logs, "R1 did not run at the last step")
    return k1, dict(wall_s=wall, s_per_step=s_step, imgs_per_s=4 / s_step,
                    masked_image_share=masked,
                    masked_pixel_share=float(per.mean()), k1=k1,
                    k1_expected=want, last_losses=logs)


def phase_flop_counter():
    """Phase 62: `count_flops` of a bs-16 PRODUCTION_GFPGAN training
    forward (return_rgb, as the GAN step runs it) on the card, beside
    `analytic_gfpgan_flops`'s G term, and the forward's TFLOP/s by the
    count (CUDA events over 10 host-issued calls)."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.utils.flops import (count_flops,
                                                         dilation_extra)
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN
    net = build_network(PRODUCTION_GFPGAN).cuda().eval()
    x = torch.rand((16, 256, 256, 3), device="cuda")

    def fwd(x):
        return net(x, return_rgb=True, randomize_noise=False)

    with torch.no_grad():
        r = count_flops(fwd, x, top=100_000)
        ms = host_time_ms(fwd, [(x,)], 10)
    extra = dilation_extra(r["top_shapes"])
    g_analytic = 85e9 * 16   # analytic_gfpgan_flops's G forward at bs 16
    step = analytic_gfpgan_flops(16)
    log(f"count_flops, PRODUCTION_GFPGAN forward at bs 16 on the card: "
        f"{r['total'] / 1e12:.4f} TFLOP ({r['conv'] / 1e12:.4f} conv, "
        f"{r['matmul'] / 1e12:.4f} matmul; {len(r['top_shapes'])} shapes); "
        f"JAX's way (the transposed convs' dilated zeros counted) "
        f"{(r['total'] + extra) / 1e12:.4f}; analytic_gfpgan_flops takes "
        f"{g_analytic / 1e12:.4f} for it ({g_analytic / r['total']:.2f}× the "
        f"count: its 85 GFLOP per image is a rough conv-sum estimate of "
        f"scripts/bench_train.py) in a {step / 1e12:.4f} TFLOP step; the "
        f"forward {ms:.3f} ms, {r['total'] / ms / 1e9:.1f} TFLOP/s counted")
    require(r["total"] > 0 and r["flags"] == [], "count_flops")
    return dict(total=r["total"], conv=r["conv"], matmul=r["matmul"],
                dilation_extra=extra, analytic_g=g_analytic,
                analytic_step=step, forward_ms=ms,
                tflops_counted=r["total"] / ms / 1e9,
                top=r["top_shapes"][:8])


def phase_profiler(root):
    """Phase 63: `trace_training_window` of 3 production GAN steps at bs 4
    (one warm-up step outside): the Chrome trace must hold the three
    `train_step_*` spans and CUDA kernels."""
    from image_restoration_tpu_torch.utils.profiler import \
        trace_training_window
    model, _ = build_trainer(root, bs=4)
    batches = [{"gt": plate_batch(4, 6300 + 4 * i)} for i in range(2)]
    gen = torch.Generator("cuda").manual_seed(63)
    log_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    trace_training_window(model, batches, gen, log_dir, num_steps=3)
    wall = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e.get("dur", 0) / 1e3 for e in events
             if str(e.get("name", "")).startswith("train_step_")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    log(f"trace_training_window: 3 GAN steps at bs 4 in {wall:.2f} s "
        f"(warm-up and export included); {os.path.getsize(path) / 2**20:.1f} "
        f"MiB trace, spans "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(spans.items()))
        + f", {len(kernels)} CUDA kernel events, {busy:.1f} ms of them")
    require(set(spans) >= {"train_step_1", "train_step_2", "train_step_3"},
            f"trace spans: {sorted(spans)}")
    require(len(kernels) > 0, "the trace holds no CUDA kernel")
    del model
    torch.cuda.empty_cache()
    return dict(wall_s=wall, spans_ms=spans, kernel_events=len(kernels),
                kernel_ms=busy, mib=os.path.getsize(path) / 2 ** 20)


class _ReplayDetector:
    """Gives back one recorded `detect_image` result."""

    def __init__(self, result):
        self.result = result

    def detect_image(self, img):
        return self.result


def phase_restoration_helper():
    """Phase 64: `RestorationHelper` on one 640×480 car photo with the
    Resnet18 detector (calibrated, HELPER_CROPS detections kept) and a
    PRODUCTION_GFPGAN restorer on the card, counts at 0 (K1 39 per
    restored crop); the same detections restored and pasted on the CPU,
    montage card vs CPU ≤4 LSB max, ≤0.05 mean (phase 5's rule; TF32
    off)."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.utils.face_util import RestorationHelper
    det = build_detector("Resnet18", "cuda")
    det.keep_top_k = HELPER_CROPS
    card = Restorer(PRODUCTION_GFPGAN, device="cuda", seed=0)
    randomize_weights(card.net, seed=1)
    cpu = Restorer(PRODUCTION_GFPGAN, device="cpu", seed=0)
    cpu.net.load_state_dict({k: v.cpu() for k, v in
                             card.net.state_dict().items()})
    photo = car_photo(6400)
    seen = []
    orig = det.detect_image

    def detect(img):
        seen.append(orig(img))
        return seen[-1]

    det.detect_image = detect
    old = _tf32_off()
    kernels = _counts_zero()
    try:
        t0 = time.perf_counter()
        helper = RestorationHelper(detector=det, face_size=256)
        n = helper.detect_landmarks(photo)
        helper.warp_crop_faces()
        helper.restore_faces(card)
        got = helper.paste_faces_to_input_image()
        wall = time.perf_counter() - t0
        k1, k2, k3 = (k.launches for k in kernels)
    finally:
        _tf32_restore(old)
    other = RestorationHelper(detector=_ReplayDetector(seen[0]),
                              face_size=256)
    other.detect_landmarks(photo)
    other.warp_crop_faces()
    other.restore_faces(cpu)
    want = other.paste_faces_to_input_image()
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    log(f"RestorationHelper: {n} crops of a 640×480 photo detected, "
        f"aligned, restored and pasted in {wall:.3f} s; card vs CPU montage "
        f"max {int(d.max())} LSB, mean {float(d.mean()):.4f}; K1 {k1} "
        f"(expected {K1_LAUNCHES_PER_FORWARD * n}), K2 {k2}, K3 {k3}")
    require(n >= 1, "the helper found no plate")
    require(got.shape == photo.shape, f"montage {got.shape}")
    require(int(d.max()) <= 4 and float(d.mean()) <= 0.05,
            f"helper card vs CPU: max {int(d.max())}, mean {d.mean():.4f}")
    require(k1 == K1_LAUNCHES_PER_FORWARD * n and k2 == 0 and k3 == 0,
            f"helper launches K1 {k1}, K2 {k2}, K3 {k3}")
    return k1, dict(crops=n, wall_s=wall, lsb_max=int(d.max()),
                    lsb_mean=float(d.mean()), k1=k1)


def _world1_gan_step(root):
    """JAX's dry-run GAN step and R1 (32², batch WORLD1_GT) from a fresh
    seeded model: (losses, G and D parameters)."""
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.parallel.dryrun import (gan_degradation,
                                                             gan_options)
    model = build_model(gan_options(1, root), device="cuda")
    model.set_degradation_pipeline(gan_degradation())
    gt = np.random.default_rng(0).random((WORLD1_GT, 32, 32, 3), np.float32)
    model.optimize_parameters(1, {"gt": gt})
    params = {f"g.{k}": v.detach().clone()
              for k, v in model.net_g.state_dict().items()}
    params.update({f"d.{k}": v.detach().clone()
                   for k, v in model.net_d.state_dict().items()})
    return model.log_dict, params


def phase_world_of_one(root):
    """Phase 65: `init_dist("nccl")` in a world of one (the card has one
    H100; larger worlds run on the CPU in tests/test_torch_parallel.py),
    then: one GAN step and its R1 step through the multi-device code path
    (the collectives run on a world of one) bit-equal to the same step
    without a process group (cuDNN deterministic, TF32 off);
    `spatial_sharded_apply` of the ×4 SRVGG engine's net at world 1
    against its direct forward (the interior beyond the halo ≤1e-5 of
    max|y|); `Restorer(data_parallel=1)` (the split, the replica thread and
    the gather) bit-equal to the plain Restorer."""
    import torch.distributed as dist
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.infer import SR_MEAN_STD, Restorer
    from image_restoration_tpu_torch.parallel.dryrun import free_port
    from image_restoration_tpu_torch.parallel.spatial import \
        spatial_sharded_apply
    from image_restoration_tpu_torch.utils.dist_util import (get_dist_info,
                                                             init_dist)
    old = _tf32_off()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                          "MASTER_ADDR", "MASTER_PORT")}
    try:
        plain_losses, plain = _world1_gan_step(os.path.join(root, "plain"))
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        require(init_dist("nccl") == (0, 1), "init_dist: not a world of one")
        init_s = time.perf_counter() - t0
        try:
            world_losses, world = _world1_gan_step(os.path.join(root, "w1"))
            diff = [k for k in plain if not torch.equal(plain[k], world[k])]
            require(world_losses == plain_losses and not diff,
                    f"world-of-one GAN step differs: {diff[:5]} "
                    f"{world_losses} vs {plain_losses}")
            net = build_network(dict(type="SRVGGNetCompact", **{
                k: SR[k] for k in ("num_feat", "num_conv", "upscale")}),
                torch.Generator().manual_seed(65)).cuda().eval()
            img = torch.from_numpy(_seeded_rgb(256, 256, 6500)[None]
                                   .astype(np.float32) / 255.0).cuda()
            with torch.no_grad():
                sharded = spatial_sharded_apply(net, img,
                                                halo=RECEPTIVE_RADIUS,
                                                scale=4)
                full = net(img)
            inner = slice(4 * RECEPTIVE_RADIUS, -4 * RECEPTIVE_RADIUS)
            sp_err = float((sharded[:, inner] - full[:, inner]).abs().max()
                           / full.abs().max())
            require(sharded.shape == full.shape and sp_err <= 1e-5,
                    f"spatial_sharded_apply at world 1: {sp_err}")
            opt = dict(type="SRVGGNetCompact", num_feat=SR["num_feat"],
                       num_conv=SR["num_conv"], upscale=4)
            one = Restorer(opt, device="cuda", seed=66, **SR_MEAN_STD)
            dp = Restorer(opt, data_parallel=1, seed=66, **SR_MEAN_STD)
            u8 = np.stack([_seeded_rgb(64, 64, 6600 + i) for i in range(3)])
            photo = _seeded_rgb(200, 300, 6610)
            same = (np.array_equal(dp.restore_batch_u8(u8),
                                   one.restore_batch_u8(u8))
                    and np.array_equal(
                        dp.restore_tiled_u8(photo, tile=128, halo=8,
                                            tile_batch=3),
                        one.restore_tiled_u8(photo, tile=128, halo=8,
                                             tile_batch=3)))
            require(same, "Restorer(data_parallel=1) differs from Restorer")
            dp.mesh.close()
            info = get_dist_info()
        finally:
            dist.destroy_process_group()
    finally:
        _tf32_restore(old)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"world of one (nccl, rank/world {info}, init {init_s:.2f} s): the "
        f"GAN + R1 step through the collectives bit-equal to the plain step "
        f"({len(plain)} tensors, losses {world_losses}); "
        f"spatial_sharded_apply interior vs direct {sp_err:.2e} of max|y|; "
        f"Restorer(data_parallel=1) bit-equal to Restorer (bs 3 and tiled)")
    return dict(init_s=init_s, gan_bit_equal=True, spatial_rel_err=sp_err,
                restorer_dp1_bit_equal=True)


P66_BATCH = (16, 256, 256, 3)   # psnr_batch / ssim_batch's NHWC batch
# (mode, (h, w) in, (h, w) out): area 1024×768 → 256×192, bicubic
# 256×64 → 1024×256
P66_RESIZES = (("area", (768, 1024), (192, 256)),
               ("bicubic", (64, 256), (256, 1024)))


def phase_metrics_resize():
    """Phase 66: the device metrics `psnr_batch` / `ssim_batch` on a seeded
    P66_BATCH batch, and `resize` at `area` and `bicubic` (P66_RESIZES),
    card against CPU (TF32 off): the metrics within 1e-5 relative, the
    resizes within 1e-5 of max|CPU|; K1, K2 and K3 counted 0."""
    from image_restoration_tpu_torch.metrics.psnr_ssim import (psnr_batch,
                                                               ssim_batch)
    from image_restoration_tpu_torch.ops.resize import resize
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(66)
    pred = torch.rand(P66_BATCH, generator=g)
    gt = (pred + 0.05 * torch.randn(P66_BATCH, generator=g)).clamp_(0, 1)
    imgs = {mode: torch.rand((2, *hw, 3), generator=g)
            for mode, hw, _ in P66_RESIZES}
    old = _tf32_off()
    kernels = _counts_zero()
    try:
        card = dict(psnr=psnr_batch(pred.cuda(), gt.cuda()),
                    ssim=ssim_batch(pred.cuda(), gt.cuda()))
        card.update({mode: resize(imgs[mode].cuda(), out, mode)
                     for mode, _, out in P66_RESIZES})
        card = {k: v.cpu() for k, v in card.items()}
        k1, k2, k3 = (k.launches for k in kernels)
    finally:
        _tf32_restore(old)
    cpu = dict(psnr=psnr_batch(pred, gt), ssim=ssim_batch(pred, gt))
    cpu.update({mode: resize(imgs[mode], out, mode)
                for mode, _, out in P66_RESIZES})
    err = {k: float(((card[k] - cpu[k]).abs() / cpu[k].abs()).max())
           for k in ("psnr", "ssim")}
    err.update({mode: float((card[mode] - cpu[mode]).abs().max()
                            / cpu[mode].abs().max())
                for mode, _, _ in P66_RESIZES})
    wall = time.perf_counter() - t0
    log(f"psnr_batch / ssim_batch on {P66_BATCH}: mean PSNR "
        f"{float(cpu['psnr'].mean()):.4f} dB, mean SSIM "
        f"{float(cpu['ssim'].mean()):.6f}; card vs CPU "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f" (resizes: area {P66_RESIZES[0][1]} -> {P66_RESIZES[0][2]}, "
        f"bicubic {P66_RESIZES[1][1]} -> {P66_RESIZES[1][2]}, of max|CPU|); "
        f"K1 {k1}, K2 {k2}, K3 {k3}; {wall:.2f} s")
    for k, v in err.items():
        require(v <= 1e-5, f"phase 66 {k}: card vs CPU {v:.2e}")
    for mode, _, out in P66_RESIZES:
        require(tuple(card[mode].shape) == (2, *out, 3)
                and bool(torch.isfinite(card[mode]).all()),
                f"phase 66 {mode}: {tuple(card[mode].shape)}")
    require((k1, k2, k3) == (0, 0, 0),
            f"phase 66 launches K1 {k1}, K2 {k2}, K3 {k3}")
    return dict(card_vs_cpu=err, psnr_mean=float(cpu["psnr"].mean()),
                ssim_mean=float(cpu["ssim"].mean()), wall_s=wall)


def phase_last_modules(tmp):
    """Path 15: phases 60-66."""
    archs = phase_restorer_archs()
    ocr_k1, ocr = phase_ocr_masks(os.path.join(tmp, "ocr"))
    flops = phase_flop_counter()
    prof = phase_profiler(os.path.join(tmp, "ocr"))
    helper_k1, helper = phase_restoration_helper()
    world1 = phase_world_of_one(os.path.join(tmp, "world1"))
    metrics_resize = phase_metrics_resize()
    torch.cuda.empty_cache()
    return ocr_k1 + helper_k1, dict(restorer_archs=archs, ocr_masks=ocr,
                                    flops=flops, profiler=prof,
                                    restoration_helper=helper,
                                    world_of_one=world1,
                                    metrics_resize=metrics_resize)


# ------------------------------------------------- path 16: training evidence

CONV_SR = dict(iters=300, bs=8, chunk=25)       # phase 67
CONV_GAN = dict(iters=200, bs=8, chunk=25)      # phase 68
CONV_SR_GAIN_DB = 10.0       # JAX: +20.8 dB (live) by iteration 300
CONV_GAN_GAIN_DB = 3.0       # JAX: +5.8 dB (live) at iteration 200
ABL = dict(iters=50, bs=4, chunk=25)            # phase 69, per arm
QAT = dict(total_iters=600, chunk=100, bs=8)    # phase 70, JAX's per arm
QAT_VS_PTQ_DB = 0.3          # |QAT int8 − PTQ int8| (JAX: −0.023 dB)
INT8_VS_FLOAT_DB = 0.5       # each int8 arm against the float arm
DISTILL = dict(teacher_iters=100, student_iters=100, teacher_blocks=2,
               chunk=25, bs=8)                   # phase 71
DISTILL_MIN_DB = 20.0        # a distilled student that diverges ends far below
LONGRUN = dict(iters=100, recipe_scale=2000, bs=4, chunk=25, val_every=25,
               niqe_every=50, snapshot_iter=50)  # phase 71
LONGRUN_ENGINE_DB = 60.0     # JAX recorded 66.5 dB
# K1 forwards of the long run's export: `export_graph`'s eager warm-up, its
# trace (the wrapper counts on the fake tensors) and the round trip's live
# forward; the exported program calls the op itself, past the wrapper
EXPORT_K1_FORWARDS = 3
# phases 67 and 70, and phase 71, run in processes of their own beside
# phases 68 and 69
CHILD_PHASES = ("sr", "distill_longrun")
CHILD_TIMEOUT_S = 600


def _k1_for(steps, r1_steps, forwards):
    """K1 launches of `steps` G+D steps, `r1_steps` R1 steps and
    `forwards` G forwards of the production GAN trainer at 256²."""
    return (steps * K1_PER_GD_STEP + r1_steps * K1_PER_R1_STEP
            + forwards * K1_LAUNCHES_PER_FORWARD)


def _r1_steps(first, last):
    """R1 steps among the global iterations first..last−1 (every 16)."""
    return sum(1 for it in range(first, last) if it % 16 == 0)


def _counted(fn):
    """(fn's result, [K1, K2, K3] launches during it, wall s)."""
    kernels = _counts_zero()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    return res, [k.launches for k in kernels], wall


def phase_conv_sr():
    """Phase 67: `train_convergence` of the SRVGG ×4 SRModel at CONV_SR
    (f32, synthetic plate scenes): finite losses, the better head at least
    CONV_SR_GAIN_DB over iteration 0, no port kernel launched."""
    from image_restoration_tpu_torch.scripts import train_convergence as tc
    rep, counts, wall = _counted(lambda: tc.convergence(
        "sr", CONV_SR["iters"], CONV_SR["chunk"], CONV_SR["bs"],
        device="cuda"))
    c = rep["curve"]
    gain = tc.better_gain(c)
    log(f"SR convergence ({CONV_SR['iters']} iters, bs {CONV_SR['bs']}) in "
        f"{wall:.1f} s: val PSNR {c['val_psnr'][0]} dB at 0 -> "
        f"{c['val_psnr'][-1]} (ema) / {c['val_psnr_live'][-1]} (live), "
        f"+{gain:.2f} dB; loss {c['loss'][1]} -> {c['loss'][-1]}; K1/K2/K3 "
        f"{counts}")
    require(all(np.isfinite(v) for v in c["loss"][1:]),
            f"phase 67 losses {c['loss']}")
    require(gain >= CONV_SR_GAIN_DB, f"phase 67: +{gain:.2f} dB")
    require(counts == [0, 0, 0], f"phase 67 launches {counts}")
    return dict(curve=c, gain_db=gain, wall_s=wall, launches=counts)


def phase_conv_gfpgan():
    """Phase 68: `train_convergence` of the production GFPGAN GAN trainer
    at CONV_GAN (f32): the better head at least CONV_GAN_GAIN_DB over
    iteration 0; K1 exactly the steps' 84, the R1 steps' 15 and the
    validation forwards' 39 (one at iteration 0, two a chunk)."""
    from image_restoration_tpu_torch.scripts import train_convergence as tc
    n, chunk = CONV_GAN["iters"], CONV_GAN["chunk"]
    rep, counts, wall = _counted(lambda: tc.convergence(
        "gfpgan", n, chunk, CONV_GAN["bs"], device="cuda"))
    c = rep["curve"]
    gain = tc.better_gain(c)
    want = _k1_for(n, _r1_steps(0, n), 1 + 2 * (n // chunk))
    log(f"GFPGAN convergence ({n} iters, bs {CONV_GAN['bs']}) in "
        f"{wall:.1f} s ({wall / n * 1e3:.1f} ms an iteration, validation "
        f"included): val PSNR {c['val_psnr'][0]} dB at 0 -> "
        f"{c['val_psnr'][-1]} (ema) / {c['val_psnr_live'][-1]} (live), "
        f"+{gain:.2f} dB; l_g_pix {c['loss'][1]} -> {c['loss'][-1]}; "
        f"K1 {counts[0]} (expected {want}), K2 {counts[1]}, K3 {counts[2]}")
    require(all(np.isfinite(v) for v in c["loss"][1:]),
            f"phase 68 losses {c['loss']}")
    require(gain >= CONV_GAN_GAIN_DB, f"phase 68: +{gain:.2f} dB")
    require(counts == [want, 0, 0], f"phase 68 launches {counts}, K1 "
            f"expected {want}")
    return dict(curve=c, gain_db=gain, wall_s=wall, launches=counts,
                k1_expected=want)


def phase_gan_ablation():
    """Phase 69: `gan_ablation` at ABL: the arms start bit-equal and see
    bit-equal first three LQ batches, both stay finite, each arm's better
    head ends above its iteration 0; K1 exactly as counted."""
    from image_restoration_tpu_torch.scripts import gan_ablation as ga
    n, chunk = ABL["iters"], ABL["chunk"]
    (rep, ev), counts, wall = _counted(lambda: ga.run(
        n, 1e9, chunk, ABL["bs"], device="cuda"))
    per_arm = _k1_for(n, _r1_steps(0, n), 1 + 2 * (n // chunk) + 2)
    arms = {a: (ev["p0"][a], rep[f"arm_{a}"]) for a in ga.ARMS}
    log(f"GAN ablation (2 × {n} iters, bs {ABL['bs']}) in {wall:.1f} s: "
        + "; ".join(f"{a} {p0:.2f} -> {e['psnr']} dB ({e['head']}), SSIM "
                    f"{e['ssim']}, GMS {e['gms_vs_gt']}, NIQE {e['niqe']}"
                    for a, (p0, e) in arms.items())
        + f"; init bit-equal {ev['init_bit_equal']}, first "
        f"{ev['lq_batches_compared']} LQ batches bit-equal "
        f"{ev['lq_bit_equal']}; K1 {counts[0]} (expected {2 * per_arm}), "
        f"K2 {counts[1]}, K3 {counts[2]}")
    require(ev["init_bit_equal"], "phase 69: arms start apart")
    require(ev["lq_bit_equal"] and ev["lq_batches_compared"] == 3,
            "phase 69: the arms' LQ batches differ")
    for a, (p0, e) in arms.items():
        curve = rep[f"{a}_curve"]
        require(all(np.isfinite(v) for k in ("l_pix", "l_d")
                    for v in curve[k]), f"phase 69 {a}: {curve}")
        require(e["psnr"] > p0, f"phase 69 {a}: {e['psnr']} <= {p0:.3f}")
    require(counts == [2 * per_arm, 0, 0], f"phase 69 launches {counts}")
    return dict(report=rep, p0=ev["p0"], wall_s=wall, launches=counts)


def phase_qat_vs_ptq():
    """Phase 70: `qat_distill.bench_qat_vs_ptq` at JAX's 600 iterations an
    arm (w8a8): |QAT int8 − PTQ int8| ≤ QAT_VS_PTQ_DB, each int8 arm within
    INT8_VS_FLOAT_DB of the float arm, both scored through the served
    engine on K2, 34 launches a call."""
    from image_restoration_tpu_torch.scripts import qat_distill as qd
    rep, counts, wall = _counted(lambda: qd.bench_qat_vs_ptq(
        device="cuda", **QAT))
    calls = rep["k2_launches_per_engine_call"]
    log(f"QAT vs PTQ w8a8 (2 × {QAT['total_iters']} iters, bs {QAT['bs']}) "
        f"in {wall:.1f} s: float {rep['float_psnr']} dB, PTQ int8 "
        f"{rep['ptq_int8_psnr']}, QAT int8 {rep['qat_int8_psnr']} (QAT "
        f"float {rep['qat_float_psnr']}): QAT - PTQ "
        f"{rep['qat_minus_ptq_db']:+.3f} dB; K2 {calls} per engine call; "
        f"K1/K2/K3 {counts}")
    require(abs(rep["qat_minus_ptq_db"]) <= QAT_VS_PTQ_DB,
            f"phase 70: QAT - PTQ {rep['qat_minus_ptq_db']} dB")
    for k in ("ptq_int8_psnr", "qat_int8_psnr"):
        require(abs(rep[k] - rep["float_psnr"]) <= INT8_VS_FLOAT_DB,
                f"phase 70: {k} {rep[k]} vs float {rep['float_psnr']}")
    require(calls == [K2_LAUNCHES_PER_CALL] * 2, f"phase 70: K2 {calls}")
    require(counts == [0, 2 * K2_LAUNCHES_PER_CALL, 0],
            f"phase 70 launches {counts}")
    return dict(report=rep, wall_s=wall, launches=counts)


def phase_distill_longrun(root):
    """Phase 71: `distill_e2e` with a 2-block teacher and 100-iteration
    students (the distilled arm does not diverge: finite, its last chunk's
    loss at most its first's, its better head ≥ DISTILL_MIN_DB; the int8
    gap through K2, 34 launches), then `gfpgan_longrun` at a recipe scale
    whose 100 iterations cross both lr milestones and the pyramid removal:
    the lr and the pyramid weight each step used equal the schedule at
    each crossing, and the exported engine round-trips ≥ LONGRUN_ENGINE_DB."""
    from image_restoration_tpu_torch.scripts import distill_e2e as de
    from image_restoration_tpu_torch.scripts import gfpgan_longrun as gl
    d_dir = os.path.join(root, "distill")
    (drep, dev), d_counts, d_wall = _counted(lambda: de.run(
        device="cuda", exp_dir=d_dir, out_path=os.path.join(
            d_dir, "distill_e2e.json"), **DISTILL))
    dc = dev["curves"]["distill"]
    dist = drep["student_distill"]
    log(f"distillation (RRDB-{DISTILL['teacher_blocks']} teacher "
        f"{drep['teacher_iters']} iters, students 2 × "
        f"{DISTILL['student_iters']}) in {d_wall:.1f} s: teacher "
        f"{drep['teacher_psnr']} dB ({drep['teacher_head']}), L1 student "
        f"{drep['student_l1']['psnr']}, distilled {dist['psnr']} "
        f"({dist['head']}; distill - L1 {drep['distill_minus_l1_db']:+.3f} "
        f"dB), int8 {drep['student_distill_int8']['psnr']} dB (gap to the "
        f"teacher {drep['student_distill_int8']['gap_to_teacher_db']:+.3f}"
        f"); distilled loss {dc['loss'][0]} -> {dc['loss'][-1]}; served "
        f"{drep['served_tiles_per_sec']} tiles/s "
        f"({drep['speedup_vs_rrdb_serving']}x the teacher's); K2 "
        f"{dev['k2_launches_int8_call']} in the int8 call; K1/K2/K3 "
        f"{d_counts}")
    require(dc["loss"][-1] <= dc["loss"][0] and
            all(np.isfinite(v) for v in dc["loss"]),
            f"phase 71: the distilled arm diverged: {dc['loss']}")
    require(dist["psnr"] >= DISTILL_MIN_DB,
            f"phase 71: distilled student {dist['psnr']} dB")
    require(dev["k2_launches_int8_call"] == K2_LAUNCHES_PER_CALL,
            f"phase 71: K2 {dev['k2_launches_int8_call']} in the int8 call")
    # the scoring call, then the serving rate's warm-up and timed calls
    d_want = [0, (2 + de.SERVE_CALLS) * K2_LAUNCHES_PER_CALL, 0]
    require(d_counts == d_want, f"phase 71 distillation launches "
            f"{d_counts}, expected {d_want}")

    l_dir = os.path.join(root, "longrun")
    (lrep, lev), l_counts, l_wall = _counted(lambda: gl.run(
        budget_s=1e9, device="cuda", exp_dir=l_dir, **LONGRUN))
    milestones, remove = gl.recipe(LONGRUN["recipe_scale"])
    used = dict(zip(lev["iters"], zip(lev["lr_g"], lev["pyr_w"])))
    crossings = sorted({c + d for c in (*milestones, remove)
                        for d in (-1, 0)})
    for it in crossings:
        want = gl.schedule_at(it, milestones, remove)
        require(np.allclose(used[it], want, rtol=1e-9, atol=0),
                f"phase 71: iteration {it} used lr/pyr_w {used[it]}, the "
                f"schedule {want}")
    c = lrep["curve"]
    snap = lrep["snapshot_vs_final"]
    log(f"long run (recipe / {LONGRUN['recipe_scale']}: {LONGRUN['iters']} "
        f"iters, bs {LONGRUN['bs']}, bf16, milestones {milestones}, pyramid "
        f"removed at {remove}) in {l_wall:.1f} s: lr/pyr_w at "
        + ", ".join(f"{it}: {used[it][0]:g}/{used[it][1]:g}"
                    for it in crossings)
        + f"; val {c['val_psnr_ema']} (ema) / {c['val_psnr_live']} (live); "
        f"NIQE {lrep['niqe_curve']['niqe_ema']}; snapshot@"
        f"{snap['snapshot_iter']} {snap['snapshot_psnr']} -> final "
        f"{snap['final_psnr']} dB; engine round trip "
        f"{lev['engine_db']:.1f} dB; K1/K2/K3 {l_counts}")
    require(lev["engine_db"] >= LONGRUN_ENGINE_DB,
            f"phase 71: engine round trip {lev['engine_db']:.1f} dB")
    require(all(np.isfinite(v) for k in ("l_pix", "l_d") for v in c[k]),
            f"phase 71 long run losses {c}")
    n, chunk = LONGRUN["iters"], LONGRUN["chunk"]
    ends = range(chunk, n + 1, chunk)
    # iteration 0's validation, both heads at each validation, the EMA at
    # each NIQE, the snapshot and the final EMA, then the export
    forwards = (1 + sum(2 for d in ends if d % LONGRUN["val_every"] < chunk)
                + sum(1 for d in ends if d % LONGRUN["niqe_every"] < chunk)
                + 2 + EXPORT_K1_FORWARDS)
    l_want = [_k1_for(n, _r1_steps(0, n), forwards), 0, 0]
    require(l_counts == l_want, f"phase 71 long run launches {l_counts}, "
            f"expected {l_want}")
    return dict(distill=drep, distill_wall_s=d_wall,
                distill_launches=d_counts, longrun=lrep,
                longrun_wall_s=l_wall, longrun_launches=l_counts,
                crossings={it: used[it] for it in crossings},
                engine_db=lev["engine_db"])


def _start_child(name, root):
    """Phase `name` of CHILD_PHASES in a process of its own (this script
    with --phase), its output to root/name.log. Returns the process."""
    logf = open(os.path.join(root, f"{name}.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase", name,
             "--phase-dir", root], stdout=logf, stderr=subprocess.STDOUT,
            cwd=HERE)
    finally:
        logf.close()


def _join_child(name, proc, root):
    """Wait for a child phase, print its output and return its result."""
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    with open(os.path.join(root, f"{name}.log")) as f:
        for ln in f.read().splitlines():
            log(f"  [{name}] {ln}")
    require(rc == 0, f"phase {name} (child process): exit {rc}")
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def run_child_phase(name, root):
    """The body of `--phase NAME`: the phase on the card, its result written
    to root/name.json."""
    fn = {"sr": lambda: dict(conv_sr=phase_conv_sr(),
                             qat_vs_ptq=phase_qat_vs_ptq()),
          "distill_longrun": lambda: phase_distill_longrun(root)}[name]
    res = fn()
    with open(os.path.join(root, f"{name}.json"), "w") as f:
        json.dump(res, f, default=lambda o: o.item() if hasattr(o, "item")
                  else str(o))


def phase_training_evidence(tmp):
    """Path 16: phases 68 and 69 here while phases 67 and 70, and phase 71,
    run in processes of their own (each phase sets its counts to 0 and
    checks them as it would here); returns (K1, K2 launches, report)."""
    procs = {name: _start_child(name, tmp) for name in CHILD_PHASES}
    try:
        gan = phase_conv_gfpgan()
        abl = phase_gan_ablation()
        srq, dl = (_join_child(name, procs[name], tmp)
                   for name in CHILD_PHASES)
        sr, qat = srq["conv_sr"], srq["qat_vs_ptq"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    torch.cuda.empty_cache()
    k1 = (gan["launches"][0] + abl["launches"][0]
          + dl["longrun_launches"][0])
    k2 = qat["launches"][1] + dl["distill_launches"][1]
    return k1, k2, dict(conv_sr=sr, conv_gfpgan=gan, gan_ablation=abl,
                        qat_vs_ptq=qat, distill_longrun=dl)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report to this JSON file")
    ap.add_argument("--phase", choices=CHILD_PHASES, default=None,
                    help="run phases of path 16 alone: sr (67 and 70) or "
                         "distill_longrun (71); path 16 starts each in a "
                         "process of its own")
    ap.add_argument("--phase-dir", default=None,
                    help="--phase's working directory and result file's")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out) if args.out else None
    # the configs' paths (configs/...) are relative to the repo root
    os.chdir(HERE)

    require(torch.cuda.is_available(), "no CUDA device")
    if args.phase:
        return run_child_phase(args.phase, os.path.abspath(args.phase_dir))
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer

    t_start = time.perf_counter()
    path_s = {}

    def lap(name):
        path_s[name] = time.perf_counter() - t_start - sum(path_s.values())
        log(f"{name}: {path_s[name]:.1f} s")

    for cut in CUTS:
        log(f"cut: {cut}")
    smi = phase_device()
    build = phase_build()

    restorer = Restorer(PRODUCTION_GFPGAN, device="cuda", seed=0)
    randomize_weights(restorer.net, seed=1)
    imgs = np.stack([plate_image(256, 256, seed=i)[..., ::-1]
                     for i in range(16)])
    batches = {1: imgs[:1].copy(), 4: imgs[:4].copy(), 16: imgs.copy()}

    shapes = record_k1_shapes(restorer, batches[1])
    require(len(shapes) == K1_LAUNCHES_PER_FORWARD,
            f"{len(shapes)} K1 calls per forward")
    rows, agg, worst = phase_kernels(shapes)
    launches, req_ms = phase_main_path(restorer, batches)
    lsb, dfloat, cpu_lsb = phase_correctness(restorer, batches[4], batches[1])
    thr, peak = phase_throughput(restorer, batches)
    prof = phase_profile(restorer, batches[16])
    lap("device, build and path 1")

    k2_rows, k2_call = phase_k2_kernels()
    engine = build_sr(int8=True)
    log(f"SR engine: {engine.meta}")
    k2_launches, sr_req_ms = phase_sr_main_path(restorer, engine)
    sr_check = phase_sr_correctness()
    sr_thr = phase_sr_throughput(engine, build_sr(int8=False))
    sr_meta = engine.meta
    del engine
    torch.cuda.empty_cache()
    lap("path 2")

    k3_rows, k3_pass, k3_err, probe, k3_launches = phase_k3_kernels()
    deq_rows, deq_fwd = phase_k2_deq()
    rrdb_main = phase_rrdb_main_path()
    ladder, rrdb_prof, net23, q23 = phase_rrdb_ladder()
    rrdb_check = phase_rrdb_int8_check(net23, q23)
    del net23, q23
    torch.cuda.empty_cache()
    lap("path 3")

    detector = phase_detector()
    pipe = build_pipeline()
    pipe_launches, pipe_forwards = phase_pipeline_main_path(pipe)
    pipe_check = phase_pipeline_correctness(pipe)
    pipe_thr = phase_pipeline_throughput(pipe)
    lap("path 4")

    with tempfile.TemporaryDirectory(prefix="irt_engines_") as tmp:
        exported = phase_export(restorer, pipe, tmp)
        (art_k1, art_k2), art_check = phase_artifact_main_path(
            restorer, pipe, exported)
        del pipe
        torch.cuda.empty_cache()
        dyn = phase_dyn_int8(restorer, exported)
    exports = {k: v[1] for k, v in exported.items()}
    del restorer, exported
    torch.cuda.empty_cache()
    lap("path 5")

    with tempfile.TemporaryDirectory(prefix="irt_train_") as tmp:
        train_k1, train = phase_train(tmp)
    lap("path 6")

    with tempfile.TemporaryDirectory(prefix="irt_sr_train_") as tmp:
        qat_k2, sr_trainers = phase_sr_train(tmp)
    lap("path 7")

    with tempfile.TemporaryDirectory(prefix="irt_stylegan2_") as tmp:
        sg2_k1, stylegan2 = phase_stylegan2(tmp)
    lap("path 8")

    with tempfile.TemporaryDirectory(prefix="irt_components_") as tmp:
        comp_k1, components = phase_components(tmp)
    lap("path 9")

    with tempfile.TemporaryDirectory(prefix="irt_detector_") as tmp:
        det_k1, detector_train = phase_detector_train(tmp)
    lap("path 10")

    with tempfile.TemporaryDirectory(prefix="irt_hifacegan_") as tmp:
        hifacegan = phase_hifacegan(tmp)
    lap("path 11")

    with tempfile.TemporaryDirectory(prefix="irt_fid_") as tmp:
        fid_k1, fid = phase_fid(tmp)
    lap("path 12")

    with tempfile.TemporaryDirectory(prefix="irt_zoo_") as tmp:
        zoo_counts, zoo = phase_zoo(tmp)
    lap("path 13")

    with tempfile.TemporaryDirectory(prefix="irt_video_") as tmp:
        video_counts, video = phase_video(tmp)
    lap("path 14")

    with tempfile.TemporaryDirectory(prefix="irt_last_") as tmp:
        last_k1, last = phase_last_modules(tmp)
    lap("path 15")

    with tempfile.TemporaryDirectory(prefix="irt_evidence_") as tmp:
        ev_k1, ev_k2, evidence = phase_training_evidence(tmp)
    lap("path 16")

    a = agg[("float32", 16)]
    kernels = [{
        "name": "fused_bias_lrelu",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/fused_bias_act.cu",
        "replaces": "image_restoration_tpu/ops/pallas/fused_act_kernel.py:43",
        "launches": (launches + pipe_launches + art_k1 + train_k1 + sg2_k1
                     + comp_k1 + det_k1 + fid_k1 + last_k1 + ev_k1),
        "max_abs_err": worst,
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "int8_conv3x3_requant",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/int8_conv3x3.cu",
        "replaces": "image_restoration_tpu/ops/pallas/int8_conv.py:65",
        "launches": k2_launches + art_k2 + qat_k2 + ev_k2,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": k2_call["ms"],
        "plain_ms": k2_call["plain_ms"],
        "bound_ms": k2_call["bound_ms"],
        "bound_by": "operations",
        "library_ms": k2_call["int_mm_ms"],
    }, {
        "name": "conv3x3_im2col",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/conv3x3_im2col.cu",
        "replaces": "image_restoration_tpu/ops/pallas/im2col_conv.py:76",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_pass["ms"],
        "plain_ms": k3_pass["plain_ms"],
        "bound_ms": k3_pass["bound_ms"],
        "bound_by": max(("bytes", "operations"), key=lambda b: sum(
            r["bound_ms"] for r in k3_rows if r["bound_by"] == b)),
        "library_ms": k3_pass["cudnn_bf16_ms"],
    }]
    report = dict(
        smi=smi, build_s=build, k1_rows=rows,
        k1_per_forward={f"{dt}_bs{bs}": v for (dt, bs), v in agg.items()},
        k1_device_ms_bs16_profiler=prof["k1_device_ms"],
        main_path_launches=launches, request_ms=req_ms,
        net_k1_vs_plain_lsb=lsb, net_k1_vs_plain_float=dfloat,
        card_vs_cpu_lsb=cpu_lsb, throughput=thr, peak_mib_bs16=peak,
        profile=prof, k2_rows=k2_rows, k2_per_engine_call=k2_call,
        sr_engine=sr_meta, sr_main_path_launches=k2_launches,
        sr_request_ms=sr_req_ms, sr_correctness=sr_check,
        sr_throughput=sr_thr, k3_rows=k3_rows, k3_per_pass=k3_pass,
        k3_probe=probe, k3_probe_launches=k3_launches,
        k2_bf16_deq_rows=deq_rows, k2_bf16_deq_per_rrdb23_forward=deq_fwd,
        rrdb_main_path=rrdb_main, rrdb_ladder=ladder, rrdb_profile=rrdb_prof,
        rrdb_int8=rrdb_check, detector=detector,
        pipeline_main_path_launches=pipe_launches,
        pipeline_forwards=pipe_forwards, pipeline_correctness=pipe_check,
        pipeline_throughput=pipe_thr,
        exports=exports,
        artifact_main_path_launches=dict(k1=art_k1, k2=art_k2),
        artifact_correctness=art_check, dyn_int8=dyn, train=train,
        sr_train=sr_trainers, stylegan2=stylegan2, components=components,
        detector_train=detector_train, hifacegan=hifacegan, fid=fid,
        zoo=zoo, zoo_launches=zoo_counts, video=video,
        video_launches=video_counts, last_modules=last,
        last_modules_k1=last_k1, training_evidence=evidence,
        training_evidence_launches=dict(k1=ev_k1, k2=ev_k2), cuts=CUTS,
        path_seconds=path_s,
        seconds=time.perf_counter() - t_start,
        note="kernels[].ms/plain_ms/bound_ms: device time (calls back to "
             "back, CUDA events) and bound, summed over the 39 K1 launches "
             "of one batch-16 f32 forward, over the 34 K2 launches of "
             "one SR engine call (bf16 epilogue), and over K3's five "
             "launches of one pass over the widened stage shapes at 528² "
             "(bf16 out); K2's library_ms is torch._int_mm on the im2col "
             "matrix, the contraction alone (k2_bf16_deq_per_rrdb23_forward"
             " has the same yardstick for the RRDB half); K3's is cuDNN's "
             "bf16 conv; "
             "K3's launches are those of probe_conv.main(); K1's launches "
             "are those of the main-path phases of paths 1, 4, 5, 6, 8, 9, "
             "10, 12, 15 and 16 (4, 17, 21, 26, 36, 39, 42, 50, 61, 64, "
             "68, 69, 71), K2's those of paths 2, 5, 7 and 16 (8, 21, 31: "
             "the engine built from the QAT checkpoint; 70, 71: the "
             "trained students' int8 engines); paths 11, 13 and 14 launch "
             "none")
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
