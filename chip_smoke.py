"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit,
     the three kernel sources of csrc/ built with nvcc, all at once, and
     the SASS of the attention and conv libraries: their bf16 kernels hold
     wgmma (HGMMA) and TMA (UTMALDG) instructions, and no other kernels
     are there;
  1. each kernel entry point vs its plain PyTorch version at the main
     paths' shapes (attention: max|Δ|/max|ref| <= ATTN_REL_TOL in bf16,
     max|Δ| <= 1e-4 in f32, TF32 off; B4 by max|Δ|/max|ref| <= 1e-2 bf16,
     1e-5 f32; B5 in bf16 within one bf16 ulp of the larger magnitude, f32
     1e-4), with the kernel's, the plain version's and one library call's
     time, the card's bound for the work and the wrapper's host µs per
     call (for B5 also F.layer_norm's): B1 (per head: the SD1.5 UNet
     shapes and the SD1.5/SDXL VAE mid-block at 512², 768², 1024² and
     1536², S = 36864), B2 (head-packed, SD1.5 and SDXL base and refiner at
     their first pass's levels and at the hires pass's: SD1.5 at 1024² and
     768², SDXL at 1536²; SD1.5 at config 4's 8 CFG rows; SD2-depth's
     d = 64 heads at (2, 4096, 5·64) and (2, 1024, 10·64) and
     instruct-pix2pix's 3 edit-CFG rows at (3, 4096, 8·40) and (3, 1024,
     8·80); the SD1.5 and hybrid rows also on fused-qkv chunk views:
     d = 160 at S = 1024 takes the split-d wide kernel), B3 (4-D, the same
     shapes), B5 (LayerNorm at every UNet row count and width of both
     families, first and hires pass, config 4's 8 CFG rows, the SD2-depth
     and instruct-pix2pix UNets' rows, at CLIP's, the MiDaS ViT's
     (577, 768) in f32 at eps 1e-6 and CodeFormer's (256, 512) in f32 at
     eps 1e-5, and the upscaler zoo's f32 rows at eps 1e-5: C = 240, 180,
     360 and 60 at 331,776 rows, SCUNet's 32–256 and DAT's position-bias
     MLP's C = 5), the zoo's B2 rows (LDSR's d = 32: (1, 1024, 20·32) and
     (1, 4096, 20·32), also as fused-qkv views) and B1 f32 at S = 65536
     (LDSR's VQ decoder at a 256² input, held against the plain version over
     blocks of 4096 query rows) with one checked, timed call at S = 262144
     (a 512² input, with SDPA's f32 backends tried there), the option
     shapes of phase 4k (B2 at hypertile's tiles (8, 1024, 8·40), (32,
     1024, 8·40), (8, 1024, 10·64), ToMe's (2, 2048, 8·40), and in f32 at
     (2, 4096, 8·40) and (2, 1024, 8·80) for upcast_attn, max|Δ| <= 1e-4),
     phase 4q's shapes (B2 per model shard at (2, 4096, 4·40) and (2, 1024,
     4·80) in bf16 and f32, B1 at (1, 4096, 16384, 512) in bf16 and f32),
     and B4 (3x3 conv at the
     JAX docstring's shapes, the SD1.5 UNet's B=2 shapes and two ragged
     widths);
  2. the full-width SD1.5 UNet CFG step (B=2, latent 64² and the hires
     pass's 128², ctx 2x77x768, bf16, random weights), and at 64² with a
     random full-width ControlNet tower on the 16-px grid hint (config 4's
     step: the tower's residuals into the UNet), in three arms: the kernels
     (B2 + B5), plain LayerNorm (B2 only), and plain attention and
     LayerNorm: finite, max|Δ|/max|ref| <= 5e-2, ms and device events per
     call in each arm, launches per call equal to the plan's (the tower
     adds 4 B2 and 21 B5);
  3. the HTTP server with random-weight SD1.5 (and two upscaler files made
     from a seed at the published widths in a temporary directory,
     registered as --esrgan-models-path registers them and dropped with it:
     "R-ESRGAN 4x+", an RRDBNet of 23 blocks, nf 64, gc 32, and
     "realesr-general-x4v3", an SRVGGNetCompact of 32 convs, nf 64)
     answering BASELINE config 1
     txt2img requests (512², Euler a, 20 steps, CFG 7.5; batch 1, batch 4
     and a repeated seed): PNGs decoded with the standard library, infotext
     checked, the repeat's image within 2 uint8 levels, and the B2, B1
     (VAE decode) and B5 launch counts equal to the plan's;
  4. the same server answering BASELINE config 2 on /sdapi/v1/img2img: two
     img2img requests (denoising 0.75, one seed) on a phase-3 PNG and one
     inpaint request (rectangle mask, mask_blur 4, inpainting_fill 1): the
     repeat within 2 levels, the inpaint's pixels outside the blurred mask
     within 1 level of the init image and changed inside it, and B2, B1
     (the VAE encode and decode) and B5 launches equal to the plan's;
  4g. the rest of img2img on the same server, each request's B1, B2 and B5
     launches equal to the plan's (16 UNet calls: B2 = 160, B5 = 16 x 48 +
     CLIP's, B1 = the f32 encode and the decode): (g) an inpaint with the
     API's defaults (no inpainting_fill, no inpaint_full_res: fill 0 and the
     crop), padding 32, an off-centre rectangle: a 512² PNG, within 1 level
     of the init image outside the blurred mask, changed inside; (h)
     inpainting_fill 0 on the whole picture; (i) soft inpainting; (j) colour
     correction; (k) resize mode 3 on a 768² init; (l) return_mask and
     return_mask_composite (the mask and an RGBA composite follow the
     image); (m) TAESD encode and decode from seeded files at the published
     widths in a temporary models root: B1 = 0; (n) a tiling txt2img
     ("Tiling: True", unlike phase 3's untiled image of the seed); (o) a
     styles request through a temporary styles.csv (the infotext's prompts
     hold the style).  Logged: s/request, the wall ms of the fill (on the
     card, held equal in every pixel to the CPU's; and on the CPU) and of the
     crop + paste at 512², and TAESD's encode and decode ms against the full
     VAE's at 512² and 1024²;
  4c. BASELINE config 3 (hires fix) on the same server: two 512² → 1024²
     requests with one seed (Euler a, 20 steps, CFG 7.5, "Latent",
     denoising 0.7: 20 UNet calls at 64² and 15 at 128²), the repeat within
     2 levels, infotext naming the hires fields; one each with "Latent
     (bicubic)" and "Latent (nearest-exact)" at hr_scale 1.5 (8 steps); then
     the image-space route 512² → 1024² with R-ESRGAN 4x+ (20 steps),
     realesr-general-x4v3 and Lanczos (8 steps) (B1 = 3: the 512² decode,
     the f32 1024² encode and the 1024² decode), the upscaler's seconds
     logged apart from the request's; B2, B1 and B5 launches equal to the
     plan's; each ESRGAN net's forward of one 192² tile on the card against
     the same net on the CPU (f32, TF32 off, max|Δ|/max|ref| <= 1e-4); one
     config 3 request under torch.profiler, as phase 7, its wall the median
     of the two timed "Latent" requests;
  4d. the Extras routes on the same server (the upscale cache off):
     /extra-single-image with R-ESRGAN 4x+ at upscaling_resize 2 and
     Lanczos as upscaler_2 at visibility 0.5 on a phase-3 PNG, with
     resize_mode 1 and crop, /extra-batch-images with two images, and
     /upscalers listing the two files: sizes checked, s/image logged;
  4e. BASELINE config 4 on the same server, its files made from a seed in a
     temporary directory and registered through the registries' own
     functions (dropped at the end): a rank-16 LoRA over every UNet
     attention projection, a 2-vector embedding, a hypernetwork for widths
     768/320/640/1280, and phase 2's tower as a control_model.* fp16 file.
     (a) batch 4, 512², Euler a, 20 steps, CFG 7.5, <lora:bench:0.8> and
     the trigger, one canny unit at weight 1 on the 16-px grid: PNGs,
     infotext (the tag, "TI hashes"), B2 = 20 x (10 + 4), B1 = 1, B5 = 20 x
     (48 + 21) + CLIP's; (b) the same seed again within 2 levels, with no
     second merge; (c) guidance_end 0.5: B2 = 20 x 10 + 10 x 4; (d) a
     <hypernet:...> request; (e) a tagless request: the base UNet and CLIP
     tensors equal to before the phase (torch.equal), the image within 2
     levels of phase 3's; (f) /controlnet/detect canny on a phase-3 PNG;
     (g) one config 4 request under torch.profiler, as phase 7.  The LoRA
     merge's seconds (first time and cached), s/request and the tower's ms
     per CFG call at 8 rows are logged;
  4f. the hybrid UNets and the depth half of config 4, their files made
     from a seed in a temporary directory and dropped at the end: (a) a
     full-width SD2-depth checkpoint (the SD2 UNet with 5 input channels,
     OpenCLIP-H, the VAE and a DPT-hybrid at the published widths under
     depth_model.model.) written as an ldm fp16 .safetensors and served
     through --ckpt: two img2img requests on a phase-3 PNG with one seed
     (the repeat within 2 levels; B5 adds the MiDaS forward's 24 f32
     launches and B2 nothing) and one txt2img request (not flat); the
     tower's forward at 384² on the card against the CPU (f32, TF32 off,
     max|Δ|/max|ref| <= 1e-4), its ms and launches; (b) a random
     full-width SD1.5-inpainting UNet (9 channels) answering an inpaint
     request (pixels outside the blurred mask within 1 level, changed
     inside; B1 = 3: the init encode, the masked encode, the decode);
     (c) a random instruct-pix2pix UNet (8 channels) at image_cfg_scale 1.5
     (the UNet called on 3 rows) and 1.0 (2 rows): the images differ;
     (d) /controlnet/detect with depth_midas and hed on a phase-3 PNG at
     processor_res 512 and 384 (INTER_AREA's shrink), with seeded
     annotator files at the published widths: hints not flat, B5 = 24 for
     depth_midas, nothing for hed; (e) config 4 (batch 4, LoRA, embedding)
     with a depth_midas unit on phase 2's tower.  Every request's B1, B2
     and B5 launches equal the plan's; s/request logged;
  4h. job control and face restoration on the same server, with seeded
     face nets at the published widths written to a temporary directory
     and registered as --gfpgan-models-path / --codeformer-models-path
     register them (GFPGANv1.4-clean, CodeFormer, RetinaFace-R50):
     /face-restorers lists both; (a) a batch-4, n_iter-2 config 1 txt2img
     with Full previews in a thread while this one polls /progress and
     /internal/progress: the progress never falls, a 2x2 grid of 512²
     previews arrives and id_live_preview rises, a /skip in iteration 1
     leaves iteration 2 whole (its last image within 2 levels of phase 3's
     seed-99 batch; B2 a multiple of the per-call plan, 20 to 40 calls),
     the median /progress round trip is under 50 ms, and a second request
     stopped by /interrupt returns iteration 1's 4 images early; (b) config
     1 with restore_faces (CodeFormer, weight 0.5) twice: the infotext
     names it, the image differs from phase 3's of the seed, the repeat is
     within 2 levels, B5 = phase 3's plan + 19, B1 and B2 as phase 3's;
     (c) Extras GFPGAN at visibility 1 and CodeFormer at 0.5 on a phase-3
     PNG (B5 = 19); (d) RetinaFace at 512² and a CodeFormer restore through
     a fixed-landmark detector: 0 levels outside the pasted face's mask,
     changed inside; the host ms of align + paste-back; (e) CodeFormer's
     forward with B5 against plain LayerNorm (logits max|Δ| <= 1e-4, index
     flips only where the top-2 margin is within twice that, the image
     within 2 levels, B5 = 19 a face), GFPGAN's (image within 2 levels) and
     RetinaFace's (heads 1e-3) on the card against the CPU; (f) the ms of
     each net's forward at 512² with one profiled forward each, and
     restore_faces' s/request against phase 3's;
  4i. the upscaler zoo on the same server: one file per model written from
     a seed at the published widths to a temporary models root
     (SwinIR-L and Swin2SR in SwinIR/, Real_HAT_GAN_SRx4, DAT x4 with its
     position-bias buffers, SCUNet, and an LDSR checkpoint after CompVis'
     bsr_sr config) and registered as the server's start-up registers them
     (upscalers.register_model_dirs); /upscalers lists them; each net's
     forward of a 64² tile on the card against the CPU (f32: max|Δ|/max|ref|
     <= 1e-4; LDSR's bf16 UNet step within 5e-2, its VQ decode 1e-4); two
     4x Extras requests of a 512² phase-3 PNG per model (SCUNet at 1x, then
     Lanczos; LDSR a 256² image at ldsr_steps 50) with the upscale cache
     off: the repeat within 2 levels, 2048² (1024²) RGB PNGs that are not
     flat, each net's ms a forward (CUDA events around its forward); a
     hires fix 512² → 1024² with SwinIR-L as hr_upscaler; every request's
     launches equal to the plan written before the run (zoo_ln_plan: B5 a
     forward, B1 = B2 = 0 on the Swin nets; LDSR B2 = 100 x 6, B1 = 1);
  4a. checkpoint files: phase 3's model written as an ldm-layout
     .safetensors in its own dtypes, and a second random SD1.5 (seed 1) in
     fp16 beside it, in a temporary directory, served by an Engine built as
     `--ckpt-dir`/`--ckpt` builds it (sd_checkpoints_limit 2): phase 3's
     seed-1234 request from the file within 2 levels of phase 3's image,
     its infotext's Model hash the file's sha256[:10]; POST
     /sdapi/v1/options to the second gives another image; override_settings
     back to the first gives phase 3's image again with no file read; GET
     /sdapi/v1/sd-models lists both; B1, B2 and B5 launches equal the plan's;
     the load (s, s/GB, s to the first image) and the swap time logged; the
     files are deleted at the end of the phase;
  4b. every name of /sdapi/v1/samplers on the loaded model, one 512²
     batch-1 request of 8 steps each: an image that is not flat, infotext
     naming the sampler, B2 launches equal to the per-call plan times the
     solver's model calls (for DPM adaptive a multiple of the per-call
     plan), s/request logged;
  5. the full-width SDXL base step (B=2, latent 128², ctx 2x77x2048, y
     2x2816) and refiner step (ctx 2x77x1280, y 2x2560), and the base step
     with a random SDXL ControlNet tower, bf16, in the three arms of phase
     2, and the SDXL VAE decode at 1024² in bf16 and in its fp32 retry
     dtype;
  6. the server with random SDXL base + refiner answering two BASELINE
     config 5 requests with one seed (1024², DPM++ 2M Karras, 20 steps,
     CFG 7.0, refiner switch at 0.8): 1024x1024 PNGs, infotext naming the
     sampler, seed and refiner, the repeat within 2 uint8 levels, an image
     that is not flat, and B2, B1 and B5 launch counts equal to the plan's;
  6b. the same server answering one config 5 request with hires fix
     (hr_scale 1.5, "Latent", denoising 0.5, hr_second_pass_steps 20): the
     base runs the first pass and, under hires_fix_refiner_pass "second
     pass", hands over to the refiner inside the second (1536², latent
     192²); a 1536x1536 PNG, infotext naming Hires and Refiner, B2, B1 (the
     1536² decode, S = 36864) and B5 launches equal to the plan's;
  6c. SDXL img2img on the same server (1024², DPM++ 2M Karras, 20 steps,
     CFG 7, denoising 0.75: 16 UNet calls): (a) two requests with one seed
     on a phase-6 PNG, the repeat within 2 levels; (b) an inpaint with the
     API's defaults; (c) a random full-width SDXL UNet with 9 input channels
     on an inpaint (B1 = 3: the init encode, the masked encode, the
     decode); every request's launches equal to the plan's (B2 = 16 x 70,
     B1 = 2: the f32 encode and the decode at S = 16384, B5 = 16 x 210 +
     CLIP's); (d) one SDXL img2img request under torch.profiler, as phase 7;
  7. one more in-process SDXL request under torch.profiler (CUDA activity
     only): wall (median of two untraced requests), device busy (union of
     the kernel intervals), idle share, device time by kernel class and
     the top kernels;
  4j. the families the loader took last, each from a file written from a
     seed at the published layout into a temporary directory (free space
     checked first; each file removed when its part ends) and served
     through an Engine built as `--ckpt` builds it, with synthetic
     SentencePiece vocabularies for T5 and XLM-R: (a) SD3-medium in the
     layout of sd3_medium_incl_clips_t5xxlfp8 (MMDiT, VAE, CLIP-L and bigG
     fp16, T5-XXL's matrices F8_E4M3, 10.7 GB): the MMDiT's bf16 forward on
     the card against the file's f32 MMDiT on the CPU at a 64² latent
     (max|Δ|/max|ref| <= 5e-2); with sd3_enable_t5 off two 1024² txt2img
     requests (Euler, 20 steps, CFG 5) within 1 level, img2img at 0.75,
     hires fix 512² → 1024² ("Latent"), one request under torch.profiler;
     then sd3_enable_t5 on, /unload-checkpoint and the txt2img again with
     T5's 77 tokens after CLIP's (an image that differs); (b) SD2.1-unclip-h
     at 768²: txt2img (zero adm) and img2img (the init image's ViT-H
     embedding); (c) AltDiffusion (XLM-R large) at 512² txt2img.  Every
     request's B1, B2 and B5 launches equal the plan written before it
     (SD3 1024²: B2 = 20 x 24, B5 = 20 x 96 + CLIP's 90, B1 = 1).
  4k. the options of a stock client (run on the SD1.5 server after 4b and
     on the SDXL server after 7): (a) SD1.5 512² batch 1 with, in turn, no
     option, hypertile, ToMe 0.5, upcast_attn, Zero Terminal SNR with the
     SGM noise multiplier, old emphasis, randn_source "GPU" and the plain
     request again, each with the cond cache on: s/request, each image's
     level difference from the plain one (the repeat 0 levels), launches
     equal to `options_plan` (written before the run: hypertile B2 200,
     100 of them at (8, 1024, 8·40); ToMe 100 at (2, 2048, 8·40); a
     cond-cache hit B5 960), then a ToMe request under torch.profiler, as
     phase 7; (c) the device Philox stream on the card
     against the CPU run of the same code and the host NV stream (<= 2 f32
     ulps each) and torch.randn with a CUDA generator; (d) openpose: the
     body net (seeded, published widths) on the card against the CPU at
     1e-4 (a 96² input), its ms a forward at 512², /controlnet/detect openpose and a
     request with an openpose unit on a seeded tower (B2 20 x 14); (e) a
     PNG embedding card (text chunk) in a prompt; (b) SDXL 1024² (DPM++ 2M Karras, 20 steps) with fp8_storage
     "Enable for SDXL" and cache_fp16_weight: the UNet's bytes in fp8 and
     bf16, s/request, the level difference, and the switch back restoring
     the bf16 weights bit for bit; (f) an SSD-1B-pruned SDXL file
     (`loader.load.ssd1b_state_dict`) served once at 1024² through an
     Engine with ckpt=, its launches against the pruned depths' plan.
  4l. training and interrogation on the SD1.5 server (after 4k; phase 1
     adds B5's f32 rows of BLIP's ViT-B/16 (577, 768), its BERT decoder
     (16, 768) at eps 1e-12, CLIP ViT-L/14 (257, 1024) and the text tower
     over a category of 8 items (616, 768)): (a) create/embedding and
     train/embedding on 4 seeded 512² PNGs (one RGBA, use_weight), 8
     steps, saves every 4, one preview: s per step and the peak
     allocation, every loss finite, the embedding moved, 0 B1/B2/B5
     launches inside the steps, the preview's launches equal to a 256²
     8-step txt2img's plan; a 512² request naming the embedding twice
     (infotext, the repeat within REPEAT_TOL, launches as planned); a step
     resumed from a saved embedding and .optim against the unbroken run's
     (RESUME_REL_TOL, the Adam count restored); (b) the same through
     create/hypernetwork and train/hypernetwork (layer structure 1, 2, 2,
     1, dropout on), then a request with <hypernet:...> that differs from
     the one without; (c) one TI step's loss and embedding gradient on a
     tiny model, card against CPU (GRAD_REL_TOL, f32, TF32 off, no kernel
     launched), a kernel refusing a tensor that requires grad and
     training_xattention_optimizations raising; (d) /interrogate with
     DeepDanbooru (the published plan, seeded, BOORU_TAGS tags) and with
     clip and BLIP (seeded at the published widths: ViT-B/16 384² with a
     BERT-base decoder, CLIP ViT-L/14; a vocab.txt and two category files
     the phase writes): each caption equal to the CPU port's on the same
     files, the tagger's scores within BOORU_TOL, ms a forward of each
     net, B5 launches as planned; (e) /preprocess (split, focal crop,
     flip, DeepDanbooru captions) on 3 seeded PNGs: files and captions
     byte for byte the CPU port's.  Every file lives in a temporary
     directory removed at the phase's end.
  4m. the scripts on the second process's SD1.5 server, over HTTP, with an
     always-on recording script whose hooks must come out as planned for
     every generation and no hook error logged, and each request's B1, B2
     and B5 launches equal to the plan's: /scripts and /script-info; the
     X/Y/Z plot of Steps 10, 20 x CFG 5, 7.5 with its legend off (a 1024²
     grid and four cells, each within REPEAT_TOL of the plain request of
     its settings, with its infotext), the legend (drawn in 4s) answering
     422 when the font option names a missing file (JAX's fall-back, the
     auto-hinted default font, is not ported); prompts from file over 2 lines, the seed iterated; loopback,
     2 loops; SD upscale of a phase-3 PNG x2 with Lanczos at batch 4 (9
     tiles of 512² at overlap 64 in 3 batches, a 1024² image); outpainting
     mk2, 64 px left and right (a 640 x 512 inpaint); the noise inversion
     of img2img alternative alone at 10 steps (finite, unit std, two runs
     within NOISE_REPEAT_TOL, 20 UNet calls), then the script; an sd_unet
     provider registered on list_unets whose bundle's images (its UNet's
     weights negated) differ from Automatic's and equal those of a server
     serving the bundle; the main UI's postprocessing (Lanczos x2, a 1024²
     image, "Postprocessing: Upscale").
  4n. saving and JPEG on the second process's server (after 4m), its --outdir a
     temporary directory: (a) txt2img batch 2 without and with
     save_images in turn (off, on, on, off; sdtpu_async_save on): two PNGs
     and a grid on disk, each equal in pixels and infotext to the
     response, nothing written without it; (b) the same with
     samples_format jpg: two JPEGs whose EXIF UserComment is the infotext,
     each byte for byte the port's encoding of the response's image (held
     to Pillow's bytes on the CPU), decoded within JPEG_MEAN_TOL levels of
     it on average; (c) img2img from a JPEG init image (the
     port's encoder at quality 90) and from its decoded pixels as a PNG,
     twice each: within REPEAT_TOL; (d) /internal/img2img-batch over 2
     JPEGs and 1 PNG: three 512² PNGs; (e) /internal/save-images with a zip:
     the files, the zip and the log.csv row.  Each generation's B1, B2 and
     B5 launches equal the plan's (txt2img: B1 1, B2 200, B5 986; img2img:
     B1 2 (the f32 encode, the decode), B2 160, B5 794; the batch 3x that);
     logged: the seconds of each request and the host ms of the codecs at
     512² and 1024² (PNG level 1 and JPEG quality 80 encodes, JPEG decodes
     at quality 80 and 95, 4:2:0 and 4:4:4).
  4o. the image formats after JPEG on that server (after 4n), its
     --outdir a temporary directory: (a) img2img from the phase-3 image as
     lossless WebP, lossy WebP, lossy WebP with an ALPH chunk, GIF, BMP
     (24-bit and RLE8), TIFF (LZW with the predictor, Deflate), 16-bit and
     interlaced PNG (the variants the port never writes from
     tests/torch_image_files.py), each file's decode equal to its reference
     pixels, and the image of one file of each reference (an img2img from
     every file would take the run past its limit) within REPEAT_TOL of the
     img2img from a PNG of those pixels; (b) txt2img saving with samples_format webp (lossy and
     webp_lossless), gif, bmp and tiff: each file decoding to the
     response's pixels (exactly, or within WEBP_MEAN_TOL / GIF_MEAN_TOL
     levels on average), the WebP's infotext back through /png-info; (c) a
     webp live preview from /internal/progress during a job; (d) the host
     ms of each codec at 512² and of a 1024² WebP; (e) one txt2img with a
     Full live preview every PREVIEW_EVERY steps fetched by a poller in
     png, then in webp (the seconds of each: the lossy encoder runs in the
     poll's handler).  Every request of (a), (b) and (e) launches B1, B2
     and B5 as planned (img2img B1 2, B2 160, B5 794; txt2img B1 1, B2
     200, B5 986; (e) B1 once more for each preview).
  4p. the page and the checkpoint merger on a server over two files in a
     temporary directory (phase 3's model in its own dtypes, a random
     SD1.5 of seed 2 in fp16), built as --ckpt-dir builds it: (a) GET /
     answers the port's page; (b) /sdapi/v1/modelmerger twice: (i)
     Weighted sum 0.5 with save_as_half, the file torch.equal to the
     phase's own merge of the same files on the card and on the CPU,
     listed after /refresh-checkpoints, a seed-1234 txt2img from it through
     override_settings twice (not phase 3's image, the repeat within
     REPEAT_TOL); (ii) Add difference with tertiary = secondary, its
     tensors equal to the primary's and its image within REPEAT_TOL of
     phase 3's; (c) parse-infotext of (i)'s infotext, token-count of a
     BREAK prompt against the host's count, last-result against the last
     response; (d) one (i) request with profiling_enable, whose Chrome
     trace names B2's kernel 200 times, B1's once and B5's 986 times and
     loses none of the request's kernel records (its launch records
     matched to kernel records by correlation id, behind the profiler's
     pad); (e) /internal/sysinfo names the card.  Every request launches B1 1,
     B2 200, B5 986; logged: the merges' seconds and GB/s, the profiled and
     unprofiled requests' seconds.
  4q. the parallel runtime (parallel/) on meshes that name the card several
     times (the data shards one after another, the model and row shards
     each on a thread of its own): (a) a data=4 runtime under
     the in-process server: /sdapi/v1/txt2img at 512², Euler a, 20 steps,
     batch 4, B1 4, B2 800, B5 3866 (every shard's UNet at (2, S, 8·d),
     every shard's decode), image i within DP_TOL levels of one device's
     batch-1 request of seed + i (one device's batch-4 images logged
     beside them), and a batch-3 request on the unsharded path (B1 1,
     B2 200, B5 986); (b) model=2 (batch 1) and data=2 × model=2 (batch 2)
     txt2img at 512², 4 steps, in f32, within TP_TOL levels of one device,
     B2 per model shard at (2, 4096, 4·40) and (2, 1024, 4·80); (c) a 1024² decode
     of a seeded (1, 4, 128, 128) latent on 4 row shards in bf16 and f32
     against the whole decode (B1 4 at (1, 4096, 16384, 512)), both
     decodes' ms and peak memory; (d) ring attention at (1, 8, 16384, 64)
     f32 on 4 shards against plain attention; (e) one (data=2, model=2)
     training step at SD1.5 widths, 256², batch 2, f32, against the
     one-device step: loss, parameters and gradients within their bounds,
     and the update itself, element for element above rounding level,
     within TRAIN_UPDATE_TOL of one device's; each step's ms and peak
     memory.
  4r. tensor-parallel SD3 (inside 4j, on its served SD3-medium, T5 off):
     model=2 (batch 1) and data=2 × model=2 (batch 2) at 1024² bf16,
     TP_SD3_STEPS steps, each image within TP_SD3_TOL of one device's;
     every (data, model) shard launches B2 at (2, 4173, 24·64) and B5 as
     planned (TP_SD3_STEPS × 24 and × 96).
  4s. the text on grids and cards (after 4d, on the phase-3 server): an
     X/Y/Z request with draw_legend (Prompt S/R over kerned words × Seed),
     its legend gutters inked, equal to the port's own redraw on the
     response's cells and unequal to a copy drawn without kerning; a
     prompt-matrix request with a struck-through part; an embedding card
     with its name; the host ms of a legend and a card.
  4t. the rarer image formats (after 4s, on the phase-3 server): (a) every
     format and variant of ``tests/torch_image_files.rare_files`` written
     from the phase-3 image at 512² (TGA, Netpbm, SGI, PCX / DCX, ICO, CUR,
     ICNS, PSD, DDS with BC1 / BC3 / BC7, FTEX, BLP, IMT, SUN, MSP, XBM,
     XPM, PIXAR, SPIDER, GBR, XV thumbnail, FITS, McIdas, IPTC, FLI, TIFF
     with JPEG, LZMA, Zstandard, CCITT, CMYK and float samples), each
     decoded equal to the pixels its writer put in, each decoder's host
     ms, and a 1728×2200 Group 4 page of text-like strokes, with the two
     committed files libzstd (compressed blocks: Huffman literals, FSE
     sequences) and libtiff (a Group 4 page) wrote,
     ``tests/torch_image_files.library_files``; (b) two img2img requests
     from a TGA (RLE) and a PSD (PackBits) of the image, each within REPEAT_TOL of the request from its PNG, B1, B2
     and B5 as 4o plans them; (c) a txt2img request with samples_format
     tga, the file decoded equal to the response; (d) the response saved
     as qoi, ppm, sgi, pcx, dds, im, ico and icns through
     ``save_image_with_geninfo``, each decoded equal to it (ICO's largest
     entry to its LANCZOS thumbnail, ICNS's to its BICUBIC 1024²), each
     writer's host ms.
  4u. JPEG 2000 (after 4t, on the phase-3 server): (a) every committed
     fixture of ``tests/fixtures/jpeg2000`` (``tools/write_jpeg2000_fixtures.py``:
     every code-block style, SOP / EPH, POC, PPM / PPT, an ROI, 12- and
     16-bit samples, subsampled sRGB and sYCC, a palette, and Pillow's
     512² lossless and 9/7 files) decoded to Pillow's pixels (sYCC within
     1 level), each decode's host ms; (c) phase 3's request again with
     samples_format jp2: the writer saves its 512² image as a lossless
     .jp2 (the encode's host ms); (b) img2img from that file within
     REPEAT_TOL of the request from the PNG of its pixels, B1, B2 and B5
     as 4t plans them; (c) txt2img at J2K_SAVE_SIDE², batch 2, with
     samples_format jp2 and grid_format j2k, the three files decoded equal
     to the response's images; (d) a PDF of an RGBA image of it, its
     JPXDecode stream decoded to the image.
Two processes share the card.  The first runs phases 0–2 alone, then
starts the second (this script with --second-process), which serves
phase 3 again on a server of its own and runs 4m, 4n, 4o and 4q on it,
then 5, 6, 6b, 6c, 7, 4k(b, f) and 4j; meanwhile the first runs 3, 4, 4g,
4c, 4d, 4s, 4t, 4u, 4e, 4f, 4h, 4i, 4a, 4b, 4k(a, c, d, e) and 4l.  The
first then waits for the second, copies its log into its own, and runs
4p alone (its profiled request's trace must lose no record).  Phase 1's
kernel rows and phase 2's steps are timed before the second process
starts; every later time shares the card and the host with the other
process.  A failure in either ends the run; the second process ends
with the first.
Each phase's seconds are logged as it ends.  The last two lines are the
kernels JSON and {"ok": true, "device": ...}.
Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F


# bf16 attention: max|Δ| / max|ref|.  Outputs of N(0, 1) inputs shrink as
# sqrt(e / Skv), so an absolute bound would pass a dropped kv tile at
# Skv = 16384; this one sits between the sound readings and planted faults
# (PERF.md, PR 4: one kv tile skipped, a cluster merge that drops a block)
ATTN_REL_TOL = 2e-2
F32_TOL = 1e-4
CONV_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # max|Δ| / max|ref|
# B5 in bf16: kernel and plain version both round the fp32 result once, so
# they may differ by one bf16 ulp where their fp32 sums differ in the last
# bit (plus 1e-5 near zero); at outputs in [4, 8) one ulp is 3.1e-2, above
# an absolute 2e-2
LN_ULP_TOL = 1.0
UNET_REL_TOL = 5e-2
UNET_ROUNDS = 2         # interleaved timing rounds per UNet arm
REPEAT_TOL = 2          # uint8 levels
# mean uint8 levels of a saved JPEG (quality 80) from its PNG: random weights
# make high-frequency texture, which quality 80 loses 11.8-11.9 levels of on
# average on the H100 run (quality 95: 9.9-10.1); a file that is not the
# encoding of the response fails the byte check before this sanity bound
JPEG_MEAN_TOL = 16
OVERLAY_TOL = 1         # uint8 levels, inpaint pixels outside the blurred mask
STEPS = 20
SAMPLER_STEPS = 8       # phase 4b
DENOISE = 0.75
MASK_BLUR = 4
SDXL_SWITCH_AT = 0.8
VAE_MEAN_DIFF_TOL = 2.0   # uint8 levels, SDXL VAE bf16 vs fp32 decode
HR_DENOISE = 0.7          # config 3
SDXL_HR_DENOISE = 0.5
ESRGAN_REL_TOL = 1e-4     # max|Δ| / max|ref|, one tile on the card vs the CPU, f32
ESRGAN_TILE = 192

# The card's rates for the bound of each kernel row (H100 SXM data sheet,
# dense, at the 700 W limit): bf16 tensor cores, fp32 outside the tensor
# cores (the f32 kernels and every LayerNorm, whose math is fp32), HBM3.
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# B1 rows: (name, BH, Sq, Skv, D, dtype)
B1_SHAPES = [
    ("unet_64x64_d40", 16, 4096, 4096, 40, torch.bfloat16),
    ("unet_32x32_d80", 16, 1024, 1024, 80, torch.bfloat16),
    ("vae_mid_512", 1, 4096, 4096, 512, torch.bfloat16),
    ("vae_mid_512_f32", 1, 4096, 4096, 512, torch.float32),
    ("vae_mid_768", 1, 9216, 9216, 512, torch.bfloat16),
    ("vae_mid_768_f32", 1, 9216, 9216, 512, torch.float32),   # unclip's img2img encode
    ("vae_mid_1024", 1, 16384, 16384, 512, torch.bfloat16),
    ("vae_mid_1024_f32", 1, 16384, 16384, 512, torch.float32),
    ("vae_mid_1536", 1, 36864, 36864, 512, torch.bfloat16),
    ("vae_mid_1536_f32", 1, 36864, 36864, 512, torch.float32),
    ("ragged_d64", 3, 1000, 1100, 64, torch.bfloat16),
    # phase 4q: a 1024² decode on 4 row shards (q local, k and v gathered)
    ("vae_rows4_1024", 1, 4096, 16384, 512, torch.bfloat16),
    ("vae_rows4_1024_f32", 1, 4096, 16384, 512, torch.float32),
]
# B1 at LDSR's VQ decode (phase 4i): S = the LR image's pixels, f32, held
# against the plain version taken over blocks of B1_BLOCK_ROWS query rows
# (the same exact softmax per row; its score matrix whole would be 17 GB at
# S = 65536 and 275 GB at 262144).  S·Skv passes 2³¹ from S = 46341 up.
B1_BLOCKED_SHAPES = [("ldsr_vq_256_f32", 1, 65536, 65536, 512, torch.float32)]
B1_BLOCK_ROWS = 4096
B1_LDSR_512 = 262144      # a 512² LDSR input: the kernel timed once, checked blocked
# B2 / B3 rows: (name, B, S, H, D), bf16, Sq = Skv = S
HEAD_SHAPES = [
    ("sd15_64x64", 2, 4096, 8, 40),
    ("sd15_32x32", 2, 1024, 8, 80),
    ("sdxl_base_64x64", 2, 4096, 10, 64),
    ("sdxl_base_32x32", 2, 1024, 20, 64),
    ("sdxl_refiner_64x64", 2, 4096, 12, 64),
    ("sdxl_refiner_32x32", 2, 1024, 24, 64),
    # the hires pass: SD1.5 at a 128² latent (hr_scale 2) and at 96² (1.5),
    # SDXL at 192²
    ("sd15_hr_128x128", 2, 16384, 8, 40),
    ("sd15_hr_64x64", 2, 4096, 8, 80),
    ("sd15_hr_32x32", 2, 1024, 8, 160),
    ("sd15_hr_96x96", 2, 9216, 8, 40),
    ("sd15_hr_48x48", 2, 2304, 8, 80),
    ("sdxl_base_96x96", 2, 9216, 10, 64),
    ("sdxl_base_48x48", 2, 2304, 20, 64),
    ("sdxl_refiner_96x96", 2, 9216, 12, 64),
    ("sdxl_refiner_48x48", 2, 2304, 24, 64),
    # config 4: SD1.5 at batch 4, so 8 CFG rows (the UNet and the tower)
    ("sd15_b8_64x64", 8, 4096, 8, 40),
    ("sd15_b8_32x32", 8, 1024, 8, 80),
    # the hybrid UNets (phase 4f): SD2-depth's d = 64 heads, instruct-pix2pix's
    # three edit-CFG rows
    ("sd2_depth_64x64", 2, 4096, 5, 64),
    ("sd2_depth_32x32", 2, 1024, 10, 64),
    ("p2p_b3_64x64", 3, 4096, 8, 40),
    ("p2p_b3_32x32", 3, 1024, 8, 80),
    # LDSR's legacy AttentionBlocks at ds 8 (phase 4i): 640 channels as 20
    # heads of d = 32 (launch_tc<32>, the 64-byte swizzle) at a 256² and a
    # 512² LR input
    ("ldsr_32x32", 1, 1024, 20, 32),
    ("ldsr_64x64", 1, 4096, 20, 32),
    # phase 4j: SD3's joint attention, 24 heads of d = 64 over the image's
    # tokens and the context's, ragged (1024² with CLIP's 77 tokens or CLIP
    # ⊕ T5's 154, 512² with 77); SD2.1-unclip's UNet at 768²
    ("sd3_1024_t5off", 2, 4173, 24, 64),
    ("sd3_1024_t5on", 2, 4250, 24, 64),
    ("sd3_512_t5off", 2, 1101, 24, 64),
    ("unclip_96x96", 2, 9216, 5, 64),
    ("unclip_48x48", 2, 2304, 10, 64),
    # phase 4k: hypertile's tiles (SD1.5 512²: the 64² level as 2 × 2 tiles
    # of 32², the 32² level untiled as h·w = tile²; the hires pass at 128²:
    # 4 × 4 tiles; SDXL 1024²: the 64² level as 2 × 2 tiles) and ToMe 0.5's
    # merged 64² level (its 32² level merges to 512 tokens, the plain path)
    ("sd15_hypertile_64x64", 8, 1024, 8, 40),
    ("sd15_hr_hypertile_128x128", 32, 1024, 8, 40),
    ("sdxl_hypertile_64x64", 8, 1024, 10, 64),
    ("sd15_tome_64x64", 2, 2048, 8, 40),
    # phase 4q: each model shard of the tensor-parallel SD1.5 UNet (half the
    # heads)
    ("sd15_tp2_64x64", 2, 4096, 4, 40),
    ("sd15_tp2_32x32", 2, 1024, 4, 80),
]
# upcast_attn (phase 4k): B2 at SD1.5's two long-KV levels in f32, held to
# max|Δ| <= F32_TOL
F32_HEAD_SHAPES = [
    ("sd15_upcast_64x64", 2, 4096, 8, 40),
    ("sd15_upcast_32x32", 2, 1024, 8, 80),
    ("sd15_tp2_f32_64x64", 2, 4096, 4, 40),     # phase 4q (b)
    ("sd15_tp2_f32_32x32", 2, 1024, 4, 80),
]
# B4 rows: (name, B, H, W, Cin, Cout): the shapes of the JAX kernel's
# docstring (sdwebui_tpu/ops/conv.py:6-8), the SD1.5 UNet's at B = 2 (the
# 32² and 16² levels take the split-K path: ops/conv.conv_plan) and two
# widths that no rectangle tiles (pixels past the image masked; split K)
CONV_SHAPES = [
    ("jax_doc_64x64x320", 8, 64, 64, 320, 320),
    ("jax_doc_32x32x640", 8, 32, 32, 640, 640),
    ("jax_doc_16x16x1280", 8, 16, 16, 1280, 1280),
    ("sd15_64x64x320", 2, 64, 64, 320, 320),
    ("sd15_32x32x640", 2, 32, 32, 640, 640),
    ("sd15_16x16x1280", 2, 16, 16, 1280, 1280),
    ("ragged_17x17x640", 2, 17, 17, 640, 640),
    ("ragged_33x33x320", 2, 33, 33, 320, 320),
]
# the UNets call B2 on the chunk views of their fused qkv projection
FUSED_QKV_ROWS = ("sd15_64x64", "sdxl_base_64x64", "sd15_hr_128x128", "sd15_hr_64x64",
                  "sd15_hr_32x32", "sd15_hr_96x96", "sd15_hr_48x48", "sd2_depth_64x64",
                  "sd2_depth_32x32", "p2p_b3_64x64", "p2p_b3_32x32", "ldsr_32x32",
                  "ldsr_64x64", "sd3_1024_t5off", "sd3_1024_t5on", "sd3_512_t5off",
                  "unclip_96x96", "unclip_48x48", "sd15_tp2_64x64", "sd15_tp2_32x32")
HOST_CALLS = 20           # calls per host-cost reading
# B5 rows of phase 4j: (name, rows, width); the MMDiT's bf16 and non-affine
SD3_LN_SHAPES = [("sd3_mmdit_s8192_c1536", 8192, 1536), ("sd3_mmdit_ctx154_c1536", 154, 1536),
                 ("sd3_mmdit_ctx308_c1536", 308, 1536)]
TEXT_LN_SHAPES = [("xlmr_154_c1024", 154, 1024), ("vit_h_257_c1280", 257, 1280)]
# B5 rows of phase 4l, f32: (name, rows, width, eps): BLIP's ViT-B/16 at 384²
# (577 tokens of 768) and its BERT decoder (a 16-token prefix, eps 1e-12),
# the interrogator's CLIP ViT-L/14 (257 of 1024) and its text tower over a
# category of 8 items (8 x 77 rows of 768)
INTERROGATE_LN_SHAPES = [("blip_vit_577_c768", 577, 768, 1e-5),
                         ("blip_bert_16_c768", 16, 768, 1e-12),
                         ("clip_vit_l_257_c1024", 257, 1024, 1e-5),
                         ("clip_text_616_c768", 8 * 77, 768, 1e-5)]
# B5 f32 rows of the upscaler zoo: (name, rows, width)
ZOO_LN_SHAPES = [("swinir_l_c240", 331776, 240), ("swin_c180", 331776, 180),
                 ("dat_sgfn_c360", 331776, 360), ("swinir_light_c60", 331776, 60),
                 ("scunet_c32", 589824, 32), ("scunet_c64", 147456, 64),
                 ("scunet_c128", 36864, 128), ("scunet_c256", 9216, 256),
                 ("dat_pos_c5", 945, 5)]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 2, hide_host: bool = True) -> float:
    """ms per call from CUDA events around `iters` back-to-back calls.  With
    hide_host a sleep kernel holds the stream while the host enqueues them,
    so a call whose launch costs the host more than its kernels cost the
    device is timed on the device (kernel rows); without it the time
    includes the host's launch rate (UNet calls, which are host-bound)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_host:
        torch.cuda._sleep(50_000_000)      # ~25 ms at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """µs of host time per call: `calls` back-to-back calls on an idle
    stream, no sleep kernel and no synchronisation inside the window (the
    launches queue; the wrapper's checks, allocation and ctypes call are
    what is timed)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(flops: float, nbytes: float, rate: str):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FLOPS[rate], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def reset_counts():
    from sdwebui_tpu_torch.ops import conv, flash_attention, layer_norm

    flash_attention.reset_launch_count()
    layer_norm.reset_launch_count()
    conv.reset_launch_count()


def read_counts() -> dict:
    from sdwebui_tpu_torch.ops import conv, flash_attention, layer_norm

    out = {name: flash_attention.launch_count(name) for name in flash_attention.ENTRY_POINTS}
    out["layer_norm"] = layer_norm.launch_count()
    out["conv3x3"] = conv.launch_count()
    return out


def phase_env():
    from sdwebui_tpu_torch.ops import _build

    import lzma      # TIFF's LZMA compression reads through the standard library's

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if lzma.decompress(lzma.compress(b"lzma")) != b"lzma":
        raise AssertionError("the standard library's lzma does not round-trip")
    log(f"lzma from {lzma.__file__}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:   # one nvcc per source, together
        list(pool.map(lambda name: _build.load_library(name, rebuild=True), _build.KERNELS))
    log(f"built {', '.join(f'{n}.cu' for n in _build.KERNELS)} for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {_build.build_seconds[n]:.2f} s" for n in _build.KERNELS) + ")")
    for name in SASS_KERNELS:
        sass_check(name, _build.load_library(name)._name)
    return smi


def sass_counts(lib_path: str) -> dict:
    """{function name: {"HGMMA": n, "UTMALDG": n}}: the wgmma and TMA load
    instructions in each device function of a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += op in line
    return counts


#: the wgmma + TMA kernels of each library, and every kernel it may hold:
#: the bf16 conv and attention kernels that replaced the mma.sync ones
SASS_KERNELS = {
    "flash_attention": (("attn_tc_kernel", "attn_wide_kernel"),
                        ("attn_tc_kernel", "attn_wide_kernel", "attn_f32_kernel")),
    "conv3x3": (("conv_wgmma_kernel",), ("conv_wgmma_kernel", "conv_f32_kernel")),
}


def sass_check(name: str, lib_path: str):
    """The wgmma kernels of a built library are what was built: each one's
    SASS holds HGMMA (wgmma) and UTMALDG (TMA loads) instructions, and the
    library holds no kernel but the listed ones."""
    wgmma, known = SASS_KERNELS[name]
    counts = {}
    for fn, ops in sass_counts(lib_path).items():
        kernel = next((k for k in known if k in fn), fn)
        mine = counts.setdefault(kernel, {"HGMMA": 0, "UTMALDG": 0})
        for op, n in ops.items():
            mine[op] += n
    log(f"{name} SASS: {counts}")
    unknown = set(counts) - set(known)
    if unknown:
        raise AssertionError(f"{name} holds other kernels than {known}: {sorted(unknown)}")
    for kernel in wgmma:
        if not (counts.get(kernel, {}).get("HGMMA") and counts[kernel]["UTMALDG"]):
            raise AssertionError(f"{kernel} lacks wgmma or TMA instructions: {counts}")


def bf16_ulps(out, ref) -> float:
    """max |Δ| in bf16 units in the last place of the larger magnitude,
    after 1e-5 absolute for outputs near zero (where x − mean cancels)."""
    a = torch.maximum(out.float().abs(), ref.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return (((out.float() - ref.float()).abs() - 1e-5).clamp_min(0) / ulp).max().item()


def agreement(out, ref, dtype, rel_tol=None, ulp_tol=None) -> dict:
    """How far a kernel's output lies from its plain version's, against the
    row's bound: relative to max|ref| (rel_tol), in bf16 ulps (ulp_tol, bf16
    only), or else absolute (F32_TOL)."""
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    rel = err / max(ref_max, 1e-30)
    ulps = bf16_ulps(out, ref) if ulp_tol is not None and dtype == torch.bfloat16 else None
    if ulps is not None:
        tol, ok = ulp_tol, ulps <= ulp_tol
        text = f"max|Δ| {err:.3e}, {ulps:.2f} bf16 ulps (tol {tol:g} ulp)"
    elif rel_tol is None:
        tol, ok = F32_TOL, err <= F32_TOL
        text = f"max|Δ| {err:.3e} (tol {tol:g}), max|ref| {ref_max:.3e}"
    else:
        tol, ok = rel_tol, rel <= rel_tol
        text = f"max|Δ| {err:.3e}, /max|ref| {ref_max:.3e} = {rel:.3e} (tol {tol:g})"
    return dict(max_abs_err=err, max_ref=ref_max, rel_err=rel, ulps=ulps, tol=tol, ok=ok,
                text=text)


def _compare(entry, name, shape, dtype, kernel, plain, library, work, rows, rel_tol=None,
             ulp_tol=None, library_host=False, iters: int = 5, warmup: int = 2,
             host_calls: int = HOST_CALLS):
    """One kernel row: the kernel vs its plain version on the same inputs
    (see agreement), then the kernel's, the plain version's and the library
    call's times, and the host µs per call of the kernel's wrapper (and of
    the library call where library_host); work = (flops, bytes, rate) for
    the bound; iters / warmup / host_calls: fewer for rows of seconds."""
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype, rel_tol, ulp_tol)
    del out, ref
    ms = cuda_ms(kernel, iters, warmup)
    plain_ms = cuda_ms(plain, iters, warmup)
    library_ms = cuda_ms(library, iters, warmup)
    host = host_us(kernel, host_calls)
    lib_host = host_us(library, host_calls) if library_host else None
    bound_ms, bound_by = bound(*work)
    log(f"{entry} {name} {tuple(shape)} {str(dtype)[6:]}: {agree['text']}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), host {host:.1f} µs/call"
        + (f" (library {lib_host:.1f})" if library_host else ""))
    if not agree["ok"]:
        raise AssertionError(f"{entry} disagrees with its plain version at {name}: "
                             f"{agree['text']}")
    rows.append(dict(entry=entry, name=name, shape=list(shape), dtype=str(dtype)[6:],
                     max_abs_err=agree["max_abs_err"], max_ref=agree["max_ref"],
                     rel_err=agree["rel_err"], tol=agree["tol"], ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                     host_us=host, library_host_us=lib_host))


def _attn_work(bh, sq, skv, d, dtype):
    size = 2 if dtype == torch.bfloat16 else 4
    rate = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
    return 4.0 * bh * sq * skv * d, size * bh * (2 * sq + 2 * skv) * d, rate


def layer_norm_shapes():
    """(name, rows, width) of every LayerNorm on the SD1.5 and SDXL paths:
    three per transformer block at B = 2 (from the configs' build plans) at
    the first pass's latent and the hires pass's (SD1.5 at 128² and 96²,
    SDXL at 192²), SD1.5's at config 4's 8 CFG rows (the UNet's and the
    ControlNet tower's widths and row counts), SD2-depth's UNet at B = 2
    and instruct-pix2pix's at its 3 edit-CFG rows, and the CLIP-L / bigG
    encoders over cond + uncond (2 x 77 tokens).  (The MiDaS ViT's f32
    rows at eps 1e-6 are layer_norm_cases' own.)"""
    from sdwebui_tpu_torch.models.configs import (CLIP_L, OPEN_CLIP_BIGG, SD15_UNET,
                                                  SD21_UNET, SDXL_REFINER_UNET, SDXL_UNET)
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    shapes = {}
    for fam, cfg, latents, batch in (("sd15", SD15_UNET, (64, 128, 96), 2),
                                     ("sd15_b8", SD15_UNET, (64,), 8),
                                     ("sd2_depth", SD21_UNET, (64,), 2),
                                     ("sd2_unclip", SD21_UNET, (96,), 2),
                                     ("p2p_b3", SD15_UNET, (64,), 3),
                                     ("sdxl_base", SDXL_UNET, (128, 192), 2),
                                     ("sdxl_refiner", SDXL_REFINER_UNET, (128, 192), 2)):
        for latent in latents:
            for s, h, d in self_attention_calls(cfg, latent):
                shapes.setdefault(f"{fam}_s{s}_c{h * d}", (batch * s, h * d))
    shapes.update(clip_l=(2 * 77, CLIP_L.width), clip_bigg=(2 * 77, OPEN_CLIP_BIGG.width))
    return [(name, rows, c) for name, (rows, c) in shapes.items()]


def phase_kernel(device):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from sdwebui_tpu_torch.ops import flash_attention as fa

    rows = []
    sdpa = F.scaled_dot_product_attention

    def randn(shape, g, dtype):
        return _randn(shape, g, dtype, device)

    for name, bh, sq, skv, d, dtype in B1_SHAPES:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = randn((bh, sq, d), g, dtype), randn((bh, skv, d), g, dtype), \
            randn((bh, skv, d), g, dtype)
        _compare("flash_attention", name, (bh, sq, skv, d), dtype,
                 lambda: fa.flash_attention(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v),
                 lambda: sdpa(q[None], k[None], v[None]),
                 _attn_work(bh, sq, skv, d, dtype), rows,
                 rel_tol=ATTN_REL_TOL if dtype == torch.bfloat16 else None)
        del q, k, v
        torch.cuda.empty_cache()
    for name, bh, sq, skv, d, dtype in B1_BLOCKED_SHAPES:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = randn((bh, sq, d), g, dtype), randn((bh, skv, d), g, dtype), \
            randn((bh, skv, d), g, dtype)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            _compare("flash_attention", name, (bh, sq, skv, d), dtype,
                     lambda: fa.flash_attention(q, k, v), lambda: blocked_plain(q, k, v),
                     lambda: sdpa(q[None], k[None], v[None]),
                     _attn_work(bh, sq, skv, d, dtype), rows, iters=2, warmup=1, host_calls=2)
        del q, k, v
        torch.cuda.empty_cache()
    rows[-1]["ldsr_512"] = b1_at_ldsr_512(device)
    bf16 = torch.bfloat16
    for name, b, s, h, d in HEAD_SHAPES:
        g = torch.Generator(device=device).manual_seed(1)
        q, k, v = (randn((b, s, h * d), g, bf16) for _ in range(3))
        heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v)]
        work = _attn_work(b * h, s, s, d, bf16)
        _compare("flash_attention_packed", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_packed(q, k, v, num_heads=h),
                 lambda: fa.flash_attention_packed_plain(q, k, v, num_heads=h),
                 lambda: sdpa(*heads), work, rows, rel_tol=ATTN_REL_TOL)
        q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        _compare("flash_attention_4d", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_4d(q4, k4, v4),
                 lambda: fa.flash_attention_4d_plain(q4, k4, v4),
                 lambda: sdpa(*heads), work, rows, rel_tol=ATTN_REL_TOL)
        if name in FUSED_QKV_ROWS:   # the chunk views of a fused projection
            qkv = randn((b, s, 3 * h * d), g, bf16)
            qc, kc, vc = qkv.chunk(3, dim=-1)
            chunk_heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (qc, kc, vc)]
            _compare("flash_attention_packed", name + "_fused_qkv", (b, s, h, d), bf16,
                     lambda: fa.flash_attention_packed(qc, kc, vc, num_heads=h),
                     lambda: fa.flash_attention_packed_plain(qc, kc, vc, num_heads=h),
                     lambda: sdpa(*chunk_heads), work, rows, rel_tol=ATTN_REL_TOL)
            del qkv, qc, kc, vc, chunk_heads
        del q, k, v, q4, k4, v4, heads
        torch.cuda.empty_cache()

    f32 = torch.float32
    for name, b, s, h, d in F32_HEAD_SHAPES:
        g = torch.Generator(device=device).manual_seed(2)
        q, k, v = (randn((b, s, h * d), g, f32) for _ in range(3))
        heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v)]
        _compare("flash_attention_packed", name, (b, s, h, d), f32,
                 lambda: fa.flash_attention_packed(q, k, v, num_heads=h),
                 lambda: fa.flash_attention_packed_plain(q, k, v, num_heads=h),
                 lambda: sdpa(*heads), _attn_work(b * h, s, s, d, f32), rows)
        qkv = randn((b, s, 3 * h * d), g, f32)   # the fused projection's chunk views
        qc, kc, vc = qkv.chunk(3, dim=-1)
        chunk_heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (qc, kc, vc)]
        _compare("flash_attention_packed", name + "_fused_qkv", (b, s, h, d), f32,
                 lambda: fa.flash_attention_packed(qc, kc, vc, num_heads=h),
                 lambda: fa.flash_attention_packed_plain(qc, kc, vc, num_heads=h),
                 lambda: sdpa(*chunk_heads), _attn_work(b * h, s, s, d, f32), rows)
        del q, k, v, heads, qkv, qc, kc, vc, chunk_heads
        torch.cuda.empty_cache()

    for case in layer_norm_cases(device):
        _compare(**case, rows=rows, library_host=True)
    for case in conv_cases(device):
        _compare(**case, rows=rows)
    torch.cuda.empty_cache()
    return rows


def blocked_plain(q, k, v, block: int = B1_BLOCK_ROWS):
    """flash_attention_plain over blocks of `block` query rows: each row's
    softmax is whole, the score matrix is never held at once."""
    from sdwebui_tpu_torch.ops import flash_attention as fa

    return torch.cat([fa.flash_attention_plain(q[:, i:i + block], k, v)
                      for i in range(0, q.shape[1], block)], dim=1)


def b1_at_ldsr_512(device) -> dict:
    """B1 f32 at S = 262144, d = 512 (a 512² LDSR input's VQ decode): one
    call, timed with CUDA events and checked against blocked_plain (max|Δ|
    <= F32_TOL);
    SDPA's f32 backends tried at the same inputs, one timed call each, or
    the error each gives (library_ms: the fastest that ran)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from sdwebui_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (_randn((1, B1_LDSR_512, 512), g, torch.float32, device) for _ in range(3))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fa.flash_attention(q, k, v)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    agree = agreement(out, blocked_plain(q, k, v), torch.float32)
    del out
    bound_ms, bound_by = bound(*_attn_work(1, B1_LDSR_512, B1_LDSR_512, 512, torch.float32))
    log(f"flash_attention ldsr_vq_512_f32 (1, {B1_LDSR_512}, {B1_LDSR_512}, 512) float32: "
        f"{agree['text']}, kernel {ms:.1f} ms (one call), bound {bound_ms:.1f} ms ({bound_by})")
    if not agree["ok"]:
        raise AssertionError(f"flash_attention disagrees at S = {B1_LDSR_512}: {agree['text']}")
    library = {}
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                library[backend.name] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                    iters=1, warmup=0)
        except (RuntimeError, torch.OutOfMemoryError) as e:
            library[backend.name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        torch.cuda.empty_cache()
    log(f"SDPA f32 at S = {B1_LDSR_512}, d = 512: {library}")
    ran = [t for t in library.values() if isinstance(t, float)]
    del q, k, v
    torch.cuda.empty_cache()
    return dict(s=B1_LDSR_512, max_abs_err=agree["max_abs_err"], ms=ms, bound_ms=bound_ms,
                library_ms=min(ran) if ran else None, library=library)


def _randn(shape, g, dtype, device):
    return torch.randn(shape, generator=g, device=device).to(dtype)


def layer_norm_cases(device):
    """The B5 rows of phase 1, one at a time (each row's tensors live while
    it is compared): _compare's arguments without `rows`."""
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod

    for dtype in (torch.bfloat16, torch.float32):
        size = 2 if dtype == torch.bfloat16 else 4
        for name, n_rows, c in layer_norm_shapes():
            g = torch.Generator(device=device).manual_seed(2)
            x = (_randn((n_rows, c), g, torch.float32, device) * 2 + 0.5).to(dtype)
            w, b = _randn((c,), g, dtype, device), _randn((c,), g, dtype, device)
            yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=dtype,
                       kernel=lambda: ln_mod.layer_norm(x, w, b),
                       plain=lambda: ln_mod.layer_norm_plain(x, w, b),
                       library=lambda: F.layer_norm(x, (c,), w, b, 1e-5),
                       work=(7.0 * n_rows * c, size * (2 * n_rows * c + 2 * c), "fp32"),
                       ulp_tol=LN_ULP_TOL)
    # the MiDaS ViT (phase 4f): 577 tokens of 768 at batch 1, f32, eps 1e-6
    g = torch.Generator(device=device).manual_seed(2)
    x = _randn((577, 768), g, torch.float32, device) * 2 + 0.5
    w, b = _randn((768,), g, torch.float32, device), _randn((768,), g, torch.float32, device)
    yield dict(entry="layer_norm", name="midas_vit_577", shape=(577, 768), dtype=torch.float32,
               kernel=lambda: ln_mod.layer_norm(x, w, b, 1e-6),
               plain=lambda: ln_mod.layer_norm_plain(x, w, b, 1e-6),
               library=lambda: F.layer_norm(x, (768,), w, b, 1e-6),
               work=(7.0 * 577 * 768, 4 * (2 * 577 * 768 + 2 * 768), "fp32"))
    # the upscaler zoo (phase 4i), f32 at eps 1e-5: each width at its rows
    # over the 9 tiles of a 512² image (192² for the Swin nets, SCUNet's
    # 256² and its three downsampled levels), SwinIR lightweight's 60 and DAT's
    # position-bias MLP (C = 5, the loop kernel)
    for name, n_rows, c in ZOO_LN_SHAPES:
        g = torch.Generator(device=device).manual_seed(2)
        xz = _randn((n_rows, c), g, torch.float32, device) * 2 + 0.5
        wz, bz = _randn((c,), g, torch.float32, device), _randn((c,), g, torch.float32, device)
        yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=torch.float32,
                   kernel=lambda: ln_mod.layer_norm(xz, wz, bz),
                   plain=lambda: ln_mod.layer_norm_plain(xz, wz, bz),
                   library=lambda: F.layer_norm(xz, (xz.shape[1],), wz, bz, 1e-5),
                   work=(7.0 * n_rows * c, 4 * (2 * n_rows * c + 2 * c), "fp32"))
    # phase 4j: the MMDiT's non-affine LayerNorms (bf16, eps 1e-6) on the
    # image's 2 x 4096 rows at 1024² and the context's 2 x 77 / 2 x 154;
    # XLM-R's 2 x 77 rows of 1024 and ViT-H's 257 of 1280 (f32, eps 1e-5)
    for name, n_rows, c in SD3_LN_SHAPES:
        g = torch.Generator(device=device).manual_seed(2)
        xs = (_randn((n_rows, c), g, torch.float32, device) * 2 + 0.5).to(torch.bfloat16)
        yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=torch.bfloat16,
                   kernel=lambda: ln_mod.layer_norm(xs, eps=1e-6),
                   plain=lambda: ln_mod.layer_norm_plain(xs, eps=1e-6),
                   library=lambda: F.layer_norm(xs, (xs.shape[1],), eps=1e-6),
                   work=(7.0 * n_rows * c, 2 * 2 * n_rows * c, "fp32"), ulp_tol=LN_ULP_TOL)
    for name, n_rows, c in TEXT_LN_SHAPES:
        g = torch.Generator(device=device).manual_seed(2)
        xt = _randn((n_rows, c), g, torch.float32, device) * 2 + 0.5
        wt, bt = _randn((c,), g, torch.float32, device), _randn((c,), g, torch.float32, device)
        yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=torch.float32,
                   kernel=lambda: ln_mod.layer_norm(xt, wt, bt),
                   plain=lambda: ln_mod.layer_norm_plain(xt, wt, bt),
                   library=lambda: F.layer_norm(xt, (xt.shape[1],), wt, bt, 1e-5),
                   work=(7.0 * n_rows * c, 4 * (2 * n_rows * c + 2 * c), "fp32"))
    for name, n_rows, c, eps in INTERROGATE_LN_SHAPES:
        g = torch.Generator(device=device).manual_seed(2)
        xi = _randn((n_rows, c), g, torch.float32, device) * 2 + 0.5
        wi, bi = _randn((c,), g, torch.float32, device), _randn((c,), g, torch.float32, device)
        yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=torch.float32,
                   kernel=lambda: ln_mod.layer_norm(xi, wi, bi, eps),
                   plain=lambda: ln_mod.layer_norm_plain(xi, wi, bi, eps),
                   library=lambda: F.layer_norm(xi, (xi.shape[1],), wi, bi, eps),
                   work=(7.0 * n_rows * c, 4 * (2 * n_rows * c + 2 * c), "fp32"))
    # CodeFormer's transformer (phase 4h): 256 codes of 512 per face, f32, eps 1e-5
    g = torch.Generator(device=device).manual_seed(2)
    xc = _randn((256, 512), g, torch.float32, device) * 2 + 0.5
    wc, bc = _randn((512,), g, torch.float32, device), _randn((512,), g, torch.float32, device)
    yield dict(entry="layer_norm", name="codeformer_256", shape=(256, 512), dtype=torch.float32,
               kernel=lambda: ln_mod.layer_norm(xc, wc, bc),
               plain=lambda: ln_mod.layer_norm_plain(xc, wc, bc),
               library=lambda: F.layer_norm(xc, (512,), wc, bc, 1e-5),
               work=(7.0 * 256 * 512, 4 * (2 * 256 * 512 + 2 * 512), "fp32"))


def conv_cases(device):
    """The B4 rows of phase 1, as layer_norm_cases."""
    from sdwebui_tpu_torch.ops import conv as conv_mod

    cl = torch.channels_last
    for dtype in (torch.bfloat16, torch.float32):
        size = 2 if dtype == torch.bfloat16 else 4
        for name, bsz, hh, ww, cin, cout in CONV_SHAPES:
            g = torch.Generator(device=device).manual_seed(3)
            x = _randn((bsz, cin, hh, ww), g, dtype, device).contiguous(memory_format=cl)
            w = (_randn((cout, cin, 3, 3), g, dtype, device) * 0.05).contiguous(memory_format=cl)
            b = _randn((cout,), g, dtype, device)
            flops = 2.0 * bsz * hh * ww * 9 * cin * cout
            nbytes = size * (bsz * hh * ww * (cin + cout) + 9 * cin * cout + cout)
            yield dict(entry="conv3x3", name=name, shape=(bsz, hh, ww, cin, cout), dtype=dtype,
                       kernel=lambda: conv_mod.conv3x3(x, w, b),
                       plain=lambda: conv_mod.conv3x3_plain(x, w, b),
                       library=lambda: F.conv2d(x, w, b, 1, 1),
                       work=(flops, nbytes, "bf16_tensor" if dtype == torch.bfloat16 else "fp32"),
                       rel_tol=CONV_REL_TOL[dtype])


def device_events(fn) -> int:
    """Device activities (kernels, copies, sets) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


@contextlib.contextmanager
def _all_plain():
    """Plain attention and plain LayerNorm: the yardstick arm."""
    from sdwebui_tpu_torch.ops import norms
    from sdwebui_tpu_torch.ops.attention import forced_impl

    with forced_impl("plain"), norms.forced_plain():
        yield


def _unet_step(label, unet, cfg, latent, x, t, ctx, y=None, tower=None, hint=None):
    """The UNet call in three arms: the kernels (attention kernels + B5),
    plain LayerNorm, and plain attention with plain LayerNorm.  With a
    ControlNet tower, each call runs the tower on `hint` first and the UNet
    takes its residuals (config 4's CFG step)."""
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod
    from sdwebui_tpu_torch.ops import norms

    arms = {"kernels": contextlib.nullcontext, "plain_layer_norm": norms.forced_plain,
            "plain": _all_plain}
    if tower is None:
        step = lambda: unet(x, t, ctx, y)  # noqa: E731
    else:
        step = lambda: unet(x, t, ctx, y, control=tower(x, t, ctx, hint, y))  # noqa: E731
    res, outs = {}, {}
    with torch.inference_mode():
        for arm, ctx_mgr in arms.items():
            with ctx_mgr():
                reset_counts()
                outs[arm] = step().float()
                torch.cuda.synchronize()
                if arm == "kernels":
                    towers = 0 if tower is None else 1
                    planned = (launch_plan(cfg, latent) + towers * launch_plan(cfg, latent, False),
                               0, ln_plan(cfg, latent) + towers * ln_plan(cfg, latent, False))
                    counted = (fa.launch_count("flash_attention_packed"), fa.launch_count(),
                               ln_mod.launch_count())
                    log(f"{label}: (B2, B1, B5) launches per call {counted}, planned {planned}")
                    if counted != planned:
                        raise AssertionError(f"{label}: launches {counted} != planned {planned}")
                    res["launches_per_call"] = dict(zip(("b2", "b1", "b5"), counted))
                res[f"{arm}_events"] = device_events(step)
        # the step is host-bound and the host's pace drifts within a run, so
        # the arms take turns and each reports the median of its rounds
        times = {arm: [] for arm in arms}
        for _ in range(UNET_ROUNDS):
            for arm, ctx_mgr in arms.items():
                with ctx_mgr():
                    times[arm].append(cuda_ms(step, iters=5, hide_host=False))
        for arm, ts in times.items():
            res[f"{arm}_ms"] = statistics.median(ts)
    ref = outs["plain"]
    for arm in ("kernels", "plain_layer_norm"):
        out = outs[arm]
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise AssertionError(f"non-finite {label} UNet output ({arm})")
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        res[f"{arm}_rel_err"] = rel
        if tuple(out.shape) != tuple(x.shape) or not rel <= UNET_REL_TOL:
            raise AssertionError(f"{label} UNet {arm} arm disagrees with the plain arm: {rel}")
    log(f"unet {label}: max|Δ|/max|ref| vs plain {res['kernels_rel_err']:.3e} "
        f"(bound {UNET_REL_TOL:g}); ms/call kernels {res['kernels_ms']:.2f}, plain LayerNorm "
        f"{res['plain_layer_norm_ms']:.2f}, plain {res['plain_ms']:.2f}; device events/call "
        f"{res['kernels_events']}, {res['plain_layer_norm_events']}, {res['plain_events']}")
    return res


def _grid_hint(size: int, batch: int, device) -> torch.Tensor:
    """The JAX bench's control image (bench.py:388-390): white lines every
    16 px on black, as a (batch, 3, size, size) hint in [0, 1]."""
    hint = torch.zeros((batch, 3, size, size), device=device)
    hint[:, :, ::16, :] = 1.0
    hint[:, :, :, ::16] = 1.0
    return hint


def random_tower(cfg, seed: int, device):
    """A ControlNet tower of `cfg` in bf16 with random weights from `seed`
    (every conv, the zero-convs too, N(0, 1/fan-in))."""
    from sdwebui_tpu_torch.models.controlnet import ControlNetModel
    from sdwebui_tpu_torch.models.layers import reset_random

    tower = ControlNetModel(cfg, device=device, dtype=torch.bfloat16)
    reset_random(tower, torch.Generator(device=device).manual_seed(seed))
    return tower


def phase_unet(model, device, tower):
    """The SD1.5 UNet step at the first pass's 64² latent and at the hires
    pass's 128² (config 3), and at 64² with the ControlNet tower (config
    4's step: the tower on the grid hint, its residuals into the UNet)."""
    out = {}
    for latent, with_tower in ((64, False), (128, False), (64, True)):
        g = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((2, 4, latent, latent), generator=g, device=device).to(torch.bfloat16)
        t = torch.tensor([500.0, 500.0], device=device)
        ctx = torch.randn((2, 77, 768), generator=g, device=device).to(torch.bfloat16)
        name = f"{latent}x{latent}" + ("_controlnet" if with_tower else "")
        out[name] = _unet_step(
            f"SD1.5 B=2 {name} bf16", model.unet, model.unet_cfg, latent, x, t, ctx,
            tower=tower if with_tower else None, hint=_grid_hint(8 * latent, 2, device))
        del x, ctx
        torch.cuda.empty_cache()
    return out


def launch_plan(cfg, latent: int, decoder: bool = True) -> int:
    """B2 launches of one UNet forward at latent² (decoder=False: of one
    ControlNet tower's, the encoder and middle block), from the config and
    the dispatch rule (ops/attention.py): every self-attention with Skv >=
    FLASH_MIN_KV, whatever its head dim.  No UNet call reaches B1."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    return sum(s >= FLASH_MIN_KV for s, _, _ in self_attention_calls(cfg, latent, decoder))


def ln_plan(cfg, latent: int, decoder: bool = True) -> int:
    """B5 launches of one UNet (or tower) forward: three per transformer
    block."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    return 3 * len(self_attention_calls(cfg, latent, decoder))


def clip_ln_plan(model) -> int:
    """B5 launches of one prompt encode: two per CLIP layer, the final norm
    on the pooled state, and on the hidden state when it is applied."""
    return sum(2 * c.cfg.layers + 1 + int(c.apply_final_norm)
               for c in (model.conditioner, model.conditioner2) if c is not None)


def _post(url, body=None):
    """POST `body` as JSON (GET without one); the decoded JSON answer."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def _server(engine):
    """A server around `engine` on a free port; yields its /sdapi/v1 URL."""
    from sdwebui_tpu_torch.server.api import make_server

    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _request(url, route, body, check, size, label=None, extra: int = 0,
             keep_all: bool = False) -> dict:
    """POST one generation request and check its images: (seconds, the
    last image decoded and as sent, launches); `extra` images follow the
    batch's (img2img's returned masks), decoded under "extras"; keep_all:
    every image of the batch under "all_images"."""
    from sdwebui_tpu_torch.utils.png import decode_png

    reset_counts()
    t0 = time.perf_counter()
    res = _post(f"{url}/{route}", body)
    dt = time.perf_counter() - t0
    launches = read_counts()
    first = json.loads(res["info"])["index_of_first_image"]
    images = [decode_png(base64.b64decode(b)) for b in res["images"][first:]]
    extras = [img for img, _ in images[len(images) - extra:]] if extra else []
    images = images[:len(images) - extra]
    if len(images) != body.get("batch_size", 1):
        raise AssertionError(f"{len(images)} images for batch {body.get('batch_size')}")
    for i, (img, text) in enumerate(images):
        if img.shape != (size, size, 3):
            raise AssertionError(f"image shape {img.shape}")
        check(text.get("parameters", ""), body["seed"] + i)
    log(f"{label or route} {size}² batch {len(images)} seed {body['seed']}: {dt:.3f} s, "
        f"{len(images) / dt:.3f} images/s, launches {launches}")
    out = dict(route=route, label=label or route, batch=len(images), seed=body["seed"],
               seconds=dt, images_per_s=len(images) / dt, launches=launches, image=images[-1][0],
               png_b64=res["images"][first + len(images) - 1], extras=extras,
               infotext=images[-1][1].get("parameters", ""))
    if keep_all:
        out["all_images"] = [img for img, _ in images]
    return out


def _serve(engine, route, requests, warmup, check, size):
    """POST `requests` to `route` of a server around `engine`, after an
    untimed, uncounted `warmup` request; the results of _request."""
    with _server(engine) as url:
        _post(f"{url}/{route}", warmup)
        return [_request(url, route, body, check, size) for body in requests]


def _check_repeat(results, i, j):
    a, b = results[i]["image"].astype(int), results[j]["image"].astype(int)
    delta = int(abs(a - b).max())
    log(f"repeated seed {results[i]['seed']}: max|Δ| {delta} uint8 levels (bound {REPEAT_TOL})")
    if delta > REPEAT_TOL:
        raise AssertionError(f"repeated seed differs by {delta}")
    if results[i]["image"].std() < 1.0:
        raise AssertionError("the generated image is flat")


def _check_launches(results, expected):
    launches = [r["launches"] for r in results]
    log(f"kernel launches per request {launches}, planned {expected}")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != planned {expected}")


def _plan(b1=0, b2=0, b5=0) -> dict:
    return dict(flash_attention=b1, flash_attention_packed=b2, flash_attention_4d=0,
                layer_norm=b5, conv3x3=0)


SD15_BASE = dict(prompt="a photograph of an astronaut riding a horse",
                 negative_prompt="blurry, lowres", width=512, height=512,
                 sampler_name="Euler a", steps=STEPS, cfg_scale=7.5)


def _sd15_check(params, seed):
    if f"Seed: {seed}" not in params or "Sampler: Euler a" not in params:
        raise AssertionError(f"infotext lacks seed/sampler: {params!r}")


def phase_serve(engine, model):
    requests = [dict(SD15_BASE, seed=1234, batch_size=1),
                dict(SD15_BASE, seed=99, batch_size=4),
                dict(SD15_BASE, seed=1234, batch_size=1)]
    results = _serve(engine, "txt2img", requests, dict(SD15_BASE, seed=1, batch_size=1, steps=2),
                     _sd15_check, 512)
    _check_repeat(results, 0, 2)
    expected = [_plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),   # B1: the decode
                      b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
                ] * len(requests)
    _check_launches(results, expected)
    return results


def _check_overlay(out, init, mask):
    """The inpaint's pixels outside the blurred mask within OVERLAY_TOL of
    the init image, and changed inside the mask."""
    from sdwebui_tpu_torch.utils.masking import blur_mask

    if out.shape != init.shape:
        raise AssertionError(f"inpaint image {out.shape}, init image {init.shape}")
    blurred = blur_mask(mask, MASK_BLUR)
    outside = int(abs(out.astype(int) - init.astype(int))[blurred == 0].max())
    inside = float(abs(out.astype(int) - init.astype(int))[mask > 0].mean())
    log(f"inpaint: outside the blurred mask max|Δ| {outside} uint8 levels from the init "
        f"image (bound {OVERLAY_TOL}); inside mean|Δ| {inside:.2f}")
    if outside > OVERLAY_TOL or not inside > 1.0:
        raise AssertionError(f"inpaint overlay wrong: outside {outside}, inside {inside}")


def _rect_mask_png(size: int):
    """Config 2's rectangle mask at size² (and as an RGB PNG)."""
    from sdwebui_tpu_torch.utils.png import encode_png

    mask_rgb = torch.zeros((size, size, 3), dtype=torch.uint8)
    mask_rgb[size * 5 // 16:size * 11 // 16, size // 4:size * 3 // 4] = 255
    return mask_rgb[:, :, 0].numpy(), base64.b64encode(encode_png(mask_rgb.numpy())).decode()


def phase_img2img(engine, model, init_png: str):
    """BASELINE config 2: img2img twice with one seed, then an inpaint."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils.png import decode_png

    init = decode_png(base64.b64decode(init_png))[0]
    mask, mask_png = _rect_mask_png(512)
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    inpaint = dict(base, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
                   inpaint_full_res=False)

    def check(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    results = _serve(engine, "img2img", [dict(base, seed=1234), dict(base, seed=1234), inpaint],
                     dict(base, seed=1, steps=2), check, 512)
    _check_repeat(results, 0, 1)
    _check_overlay(results[2]["image"], init, mask)
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1                  # the last t_enc + 2 sigmas; Euler a: one call per step
    expected = [_plan(b1=2, b2=calls * launch_plan(model.unet_cfg, 64),   # B1: encode, decode
                      b5=calls * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
                ] * 3
    _check_launches(results, expected)
    return results, calls


def _offcentre_mask_png(size: int):
    """Phase 4g's rectangle mask, off the centre (and as an RGB PNG)."""
    from sdwebui_tpu_torch.utils.png import encode_png

    mask = torch.zeros((size, size, 3), dtype=torch.uint8)
    mask[size * 9 // 16:size * 13 // 16, size // 8:size * 7 // 16] = 255
    return mask[:, :, 0].numpy(), base64.b64encode(encode_png(mask.numpy())).decode()


def host_ms(fn, repeats: int = 3) -> float:
    """The median host milliseconds of fn()."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def write_taesd_files(directory: str, device, seed: int = 3) -> None:
    """TAESD's encoder and decoder for SD1/SD2 at the published widths
    (64-wide blocks, 4 latent channels), seeded, where the port looks for
    them under a models root: VAE-taesd/taesd_{encoder,decoder}."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.vae_approx import random_taesd

    os.makedirs(os.path.join(directory, "VAE-taesd"))
    for i, which in enumerate(("encoder", "decoder")):
        write_safetensors(os.path.join(directory, "VAE-taesd", f"taesd_{which}.safetensors"),
                          random_taesd(which, 4, seed + i, device).state_dict())


def taesd_vs_vae(model, device) -> dict:
    """TAESD's encode and decode against the full VAE's (f32 encode, bf16
    decode, as the pipeline runs them) at 512² and 1024²: device ms each."""
    from sdwebui_tpu_torch.models import vae_approx

    enc = vae_approx.get_taesd(model.kind, "encoder", device)
    dec = vae_approx.get_taesd(model.kind, "decoder", device)
    out = {}
    for size in (512, 1024):
        g = torch.Generator(device=device).manual_seed(size)
        img = torch.rand((1, 3, size, size), generator=g, device=device)
        z = torch.randn((1, 4, size // 8, size // 8), generator=g, device=device)
        with torch.inference_mode():
            row = {
                "taesd_encode_ms": cuda_ms(lambda: vae_approx.taesd_encode(enc, img),
                                           hide_host=False),
                "vae_encode_f32_ms": cuda_ms(lambda: model.vae.encode_mode(
                    model.vae.encode_moments(img * 2 - 1)), hide_host=False),
                "taesd_decode_ms": cuda_ms(lambda: vae_approx.taesd_decode(dec, z),
                                           hide_host=False),
                "vae_decode_bf16_ms": cuda_ms(lambda: model.vae.decode(z.to(torch.bfloat16)),
                                              hide_host=False)}
        out[f"{size}x{size}"] = row
        log(f"TAESD vs the full VAE at {size}²: " + json.dumps({k: round(v, 3)
                                                                 for k, v in row.items()}))
    return out


def phase_img2img_options(engine, model, phase3: dict, directory: str, device):
    """4g: the rest of img2img on the phase-3 server: (g) an inpaint with the
    API's defaults (inpainting_fill 0, inpaint_full_res) and padding 32;
    (h) fill 0 on the whole picture; (i) soft inpainting; (j) colour
    correction; (k) resize mode 3 on a 768² init; (l) return_mask and
    return_mask_composite; (m) TAESD encode and decode; (n) a tiling
    txt2img; (o) a styles request.  Returns (results, info)."""
    from sdwebui_tpu_torch.models import vae_approx
    from sdwebui_tpu_torch.pipeline.img2img import apply_overlay, setup_img2img_steps
    from sdwebui_tpu_torch.text.styles import StyleDatabase
    from sdwebui_tpu_torch.utils import images as images_util
    from sdwebui_tpu_torch.utils import masking
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    init_png = phase3["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = SD15_BASE["width"]
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1
    i2i = _plan(b1=2, b2=calls * launch_plan(model.unet_cfg, 64),
                b5=calls * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    t2i = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    mask, mask_png = _offcentre_mask_png(size)
    masked = dict(base, mask=mask_png, mask_blur=MASK_BLUR)
    whole = dict(masked, inpaint_full_res=False)

    def check_i2i(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    big = images_util.resize(init, (768, 768), "lanczos")
    big_png = base64.b64encode(encode_png(big)).decode()
    styles_path = os.path.join(directory, "styles.csv")
    with open(styles_path, "w", encoding="utf-8") as f:
        f.write("name,prompt,negative_prompt\n"
                "chip smoke,\"{prompt}, oil painting, brush strokes\",\"photo\"\n")
    os.makedirs(os.path.join(directory, "models"))
    write_taesd_files(os.path.join(directory, "models"), device)
    prev_root, prev_styles = vae_approx.models_root(), engine.styles
    vae_approx.set_models_root(os.path.join(directory, "models"))
    engine.styles = StyleDatabase(styles_path)
    results, plans = [], []

    def run(url, route, body, label, plan, check=check_i2i, extra=0):
        results.append(_request(url, route, body, check, size, label, extra))
        plans.append(plan)
        return results[-1]

    try:
        with _server(engine) as url:
            _post(f"{url}/img2img", dict(masked, seed=1, steps=2, inpaint_full_res_padding=32))
            # (g) no inpainting_fill, no inpaint_full_res: the schema's 0 and True
            g = run(url, "img2img", dict(masked, seed=4321, inpaint_full_res_padding=32),
                    "(g) inpaint, API defaults, padding 32", i2i)
            _check_overlay(g["image"], init, mask)
            h = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=0),
                    "(h) inpainting_fill 0, whole picture", i2i)
            _check_overlay(h["image"], init, mask)
            i = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=1,
                                         soft_inpainting=True),
                    "(i) soft inpainting", i2i)
            _check_overlay(i["image"], init, mask)
            run(url, "img2img", dict(base, seed=1234, override_settings={
                "img2img_color_correction": True}), "(j) colour correction", i2i)
            k = run(url, "img2img", dict(base, seed=1234, init_images=[big_png], resize_mode=3),
                    "(k) resize mode 3, 768² init", i2i)
            l_ = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=1, override_settings={
                "return_mask": True, "return_mask_composite": True}),
                "(l) return_mask and return_mask_composite", i2i, extra=2)
            shapes = [x.shape for x in l_["extras"]]
            if shapes != [(size, size, 3), (size, size, 4)]:
                raise AssertionError(f"(l) returned masks {shapes}")
            m = run(url, "img2img", dict(base, seed=1234, override_settings={
                "sd_vae_encode_method": "TAESD", "sd_vae_decode_method": "TAESD"}),
                "(m) TAESD encode and decode", dict(i2i, flash_attention=0))
            n = run(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1, tiling=True),
                    "(n) tiling txt2img", t2i, check=_sd15_check)
            o = run(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1,
                                         styles=["chip smoke"]),
                    "(o) styles", t2i, check=_sd15_check)
        vae = taesd_vs_vae(model, device)
    finally:
        vae_approx.set_models_root(prev_root)
        engine.styles = prev_styles
    _check_launches(results, plans)
    for r in (k, m):
        if r["image"].std() < 1.0:
            raise AssertionError(f"{r['label']}: the image is flat")
    if "Tiling: True" not in n["infotext"] or (n["image"] == phase3["image"]).all():
        raise AssertionError("(n) the tiling request's infotext or image is the untiled one's")
    styled = (f"{SD15_BASE['prompt']}, oil painting, brush strokes\nNegative prompt: "
              f"{SD15_BASE['negative_prompt']}, photo\n")
    if not o["infotext"].startswith(styled):
        raise AssertionError(f"(o) infotext lacks the style: {o['infotext'][:160]!r}")

    # the host side of the default inpaint: the fill and the crop + paste
    blurred = masking.blur_mask(masking.binarize_mask(mask), MASK_BLUR)
    box = masking.expand_crop_region(masking.get_crop_region_v2(blurred > 127, 32), size,
                                     size, size, size)
    crop = images_util.resize(images_util.crop(init, box), (size, size), "lanczos")
    crop_mask = images_util.resize(images_util.crop(blurred, box), (size, size))
    info = {"mask": crop_mask, "overlay_mask": blurred, "crop_region": box, "originals": [init]}
    filled = masking.fill(crop, crop_mask, device)
    if not (filled == masking.fill(crop, crop_mask, "cpu")).all():
        raise AssertionError("masking.fill on the card differs from the CPU's")

    def card_fill():
        masking.fill(crop, crop_mask, device)
        torch.cuda.synchronize()

    host = {"fill_512_card_ms": host_ms(card_fill),
            "fill_512_cpu_ms": host_ms(lambda: masking.fill(crop, crop_mask, "cpu")),
            "crop_paste_512_ms": host_ms(lambda: apply_overlay(init, info, 0)),
            "crop_region": list(box)}
    log("inpaint fill (on the card, equal to the CPU's in every pixel) and crop + paste at "
        "512², wall ms: " + json.dumps(host))
    seconds = {r["label"]: r["seconds"] for r in results}
    log(f"(m) TAESD request {m['seconds']:.3f} s against phase 4's full-VAE img2img")
    # f32 encodes at 512² (B1's vae_mid_512_f32 row): every img2img request but TAESD's
    f32_encodes = sum(r["route"] == "img2img" for r in results) - 1
    return results, dict(seconds=seconds, host=host, taesd_vs_vae=vae,
                         f32_encodes_512=f32_encodes)


# the published widths of the two upscaler files: R-ESRGAN 4x+ (RRDBNet) and
# realesr-general-x4v3 (SRVGGNetCompact)
UPSCALER_FILES = {"R-ESRGAN 4x+": ("rrdbnet", dict(in_ch=3, nf=64, gc=32, n_blocks=23)),
                  "realesr-general-x4v3": ("srvgg", dict(nf=64, num_conv=32, scale=4))}


def write_upscaler_files(directory: str, seed: int = 0) -> dict:
    """The upscaler files, random weights from `seed` in f32: each conv
    N(0, 0.5² / fan-in), the RRDBNet's last bias lifted by 0.5, so that the
    output is neither flat nor clipped; {name: path}."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.esrgan import RRDBNet, SRVGGNetCompact

    paths = {}
    for i, (name, (arch, kw)) in enumerate(UPSCALER_FILES.items()):
        net = RRDBNet(**kw) if arch == "rrdbnet" else SRVGGNetCompact(**kw)
        g = torch.Generator().manual_seed(seed + i)
        sd = {k: torch.randn(v.shape, generator=g) * (0.5 / v[0].numel() ** 0.5 if v.ndim == 4
                                                       else 0.05)
              for k, v in net.state_dict().items()}
        if arch == "rrdbnet":
            sd["conv_last.bias"] += 0.5
        paths[name] = os.path.join(directory, name + ".safetensors")
        write_safetensors(paths[name], sd)
    return paths


def check_upscaler_nets(paths: dict, device) -> dict:
    """Each upscaler net's forward of one ESRGAN_TILE² tile on the card
    against the same net on the CPU, f32 with TF32 off."""
    from sdwebui_tpu_torch.models.esrgan import load_upscaler_net

    out = {}
    for name, path in paths.items():
        g = torch.Generator().manual_seed(5)
        x = torch.rand((1, 3, ESRGAN_TILE, ESRGAN_TILE), generator=g)
        with torch.inference_mode():
            ref = load_upscaler_net(path, "cpu")(x)
            net = load_upscaler_net(path, device)
            got = net(x.to(device))
            torch.cuda.synchronize()
            xd = x.to(device)
            ms = cuda_ms(lambda: net(xd), iters=3, warmup=1, hide_host=False)
        got = got.cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        out[name] = dict(rel_err=rel, tile_ms=ms, out_std=ref.std().item())
        log(f"{name}: one {ESRGAN_TILE}² tile, card vs CPU max|Δ|/max|ref| {rel:.3e} (bound "
            f"{ESRGAN_REL_TOL:g}), {ms:.2f} ms a tile on the card, output std {ref.std():.3f}")
        if not rel <= ESRGAN_REL_TOL or got.shape != (1, 3, 4 * ESRGAN_TILE, 4 * ESRGAN_TILE):
            raise AssertionError(f"{name} on the card disagrees with the CPU: {rel}, {got.shape}")
        del net
    torch.cuda.empty_cache()
    return out


def hires_request(seed: int, upscaler: str = "Latent", scale: float = 2.0,
                  steps: int = STEPS) -> dict:
    """BASELINE config 3: 512² → 512·scale², Euler a, 20 steps, CFG 7.5
    (`steps` in both passes)."""
    return dict(SD15_BASE, seed=seed, batch_size=1, enable_hr=True, hr_scale=scale,
                hr_upscaler=upscaler, denoising_strength=HR_DENOISE, steps=steps)


def _hires_check(upscaler: str, scale: float):
    def check(params, seed):
        _sd15_check(params, seed)
        for want in (f"Hires upscale: {scale:g}", f"Hires upscaler: {upscaler}",
                     f"Denoising strength: {HR_DENOISE}",
                     f"Size: {SD15_BASE['width']}x{SD15_BASE['height']}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")
    return check


@contextlib.contextmanager
def _timed_upscales(seconds: list):
    """Each hires upscale's seconds (upscalers.upscale_by_name)."""
    from sdwebui_tpu_torch.postprocessing import upscalers

    real = upscalers.upscale_by_name

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out
    upscalers.upscale_by_name = timed
    try:
        yield
    finally:
        upscalers.upscale_by_name = real


def phase_hires(engine, model, upscaler_paths: dict):
    """4c: BASELINE config 3 over HTTP; returns (results, summary).  The
    "Latent" requests and the first upscaler's run the full 20 steps; the
    1.5x latent modes and the other upscalers SAMPLER_STEPS, whose launch
    plans follow their steps (the upscale does not depend on them)."""
    from sdwebui_tpu_torch.pipeline.processing import setup_img2img_steps

    cfg = model.unet_cfg

    def hr_calls(steps: int) -> int:
        return setup_img2img_steps(steps, HR_DENOISE)[1] + 1

    def plan(hr_latent: int, b1: int, steps: int = STEPS) -> dict:
        n = hr_calls(steps)
        return _plan(b1=b1, b2=steps * launch_plan(cfg, 64) + n * launch_plan(cfg, hr_latent),
                     b5=steps * ln_plan(cfg, 64) + n * ln_plan(cfg, hr_latent)
                     + 2 * clip_ln_plan(model))     # the second pass encodes its prompts again

    results, plans, upscale_s = [], [], {}
    with _server(engine) as url:
        _post(f"{url}/txt2img", hires_request(1, steps=2))
        for _ in range(2):
            results.append(_request(url, "txt2img", hires_request(2024), _hires_check(
                "Latent", 2.0), 1024, "config 3 Latent"))
            plans.append(plan(128, 1))
        _check_repeat(results, 0, 1)
        for mode in ("Latent (bicubic)", "Latent (nearest-exact)"):
            results.append(_request(url, "txt2img", hires_request(
                2024, mode, 1.5, SAMPLER_STEPS), _hires_check(mode, 1.5), 768,
                f"config 3 {mode}, {SAMPLER_STEPS} steps"))
            plans.append(plan(96, 1, SAMPLER_STEPS))
        for i, name in enumerate(list(upscaler_paths) + ["Lanczos"]):
            steps, seconds = STEPS if i == 0 else SAMPLER_STEPS, []
            with _timed_upscales(seconds):
                r = _request(url, "txt2img", hires_request(2025, name, steps=steps),
                             _hires_check(name, 2.0), 1024, f"config 3 {name}, {steps} steps")
            upscale_s[name] = seconds[0]
            log(f"config 3 {name}: the upscale took {seconds[0]:.3f} s of {r['seconds']:.3f} s")
            if r["image"].std() < 1.0:
                raise AssertionError(f"config 3 {name}: the image is flat")
            results.append(dict(r, upscale_s=seconds[0]))
            plans.append(plan(128, 3, steps))
    _check_launches(results, plans)
    nets = check_upscaler_nets(upscaler_paths, engine.device)
    # the VAE attention's calls by phase-1 row: each request's decode, and on
    # the image-space route the 512² decode and the f32 1024² encode
    image_route = len(upscale_s)
    b1_calls = {("vae_mid_1024", "bfloat16"): 2 + image_route,
                ("vae_mid_768", "bfloat16"): 2, ("vae_mid_512", "bfloat16"): image_route,
                ("vae_mid_1024_f32", "float32"): image_route}
    latent_s = [r["seconds"] for r in results[:2]]
    return results, dict(hires_unet_calls=hr_calls(STEPS), upscale_s=upscale_s, nets=nets,
                         b1_calls=b1_calls, latent_wall_s=statistics.median(latent_s))


def phase_extras(engine, pngs: list, upscaler_paths: dict):
    """4d: the Extras routes with the upscale cache off."""
    from sdwebui_tpu_torch.utils.png import decode_png

    rows = []

    def run(url, route, body, shapes, label):
        reset_counts()
        t0 = time.perf_counter()
        res = _post(f"{url}/{route}", body)
        dt = time.perf_counter() - t0
        images = [res["image"]] if "image" in res else res["images"]
        got = [decode_png(base64.b64decode(b))[0].shape for b in images]
        log(f"extras {label}: {dt:.3f} s, {dt / len(images):.3f} s/image, shapes {got}")
        if got != shapes:
            raise AssertionError(f"extras {label}: shapes {got}, expected {shapes}")
        rows.append(dict(route=route, label=label, seconds=dt, images=len(images),
                         s_per_image=dt / len(images), launches=read_counts()))

    esrgan = "R-ESRGAN 4x+"
    with _server(engine) as url:
        _post(f"{url}/options", {"upscaling_max_images_in_cache": 0})
        try:
            run(url, "extra-single-image", dict(
                image=pngs[0], upscaler_1=esrgan, upscaling_resize=2, upscaler_2="Lanczos",
                extras_upscaler_2_visibility=0.5), [(1024, 1024, 3)],
                f"{esrgan} x2 + Lanczos at 0.5")
            run(url, "extra-single-image", dict(
                image=pngs[0], upscaler_1=esrgan, resize_mode=1, upscaling_resize_w=1000,
                upscaling_resize_h=700, upscaling_crop=True), [(700, 1000, 3)],
                f"{esrgan} to 1000x700, cropped")
            run(url, "extra-batch-images", dict(
                imageList=[{"data": b, "name": f"{i}.png"} for i, b in enumerate(pngs[:2])],
                upscaler_1=esrgan, upscaling_resize=2), [(1024, 1024, 3)] * 2,
                f"{esrgan} x2, batch of 2")
        finally:
            _post(f"{url}/options", {"upscaling_max_images_in_cache": 5})
        names = [u["name"] for u in _post(f"{url}/upscalers")]
    log(f"/upscalers: {names}")
    if not set(upscaler_paths) <= set(names):
        raise AssertionError(f"/upscalers lacks the files {sorted(upscaler_paths)}: {names}")
    return rows


# the upscaler zoo (phase 4i): one file per model, seeded at the published
# widths, under a temporary models root laid out as the server reads it
ZOO_REL_TOL = 1e-4        # max|Δ| / max|ref|, a zoo net's 64² forward, card vs CPU, f32
ZOO_TILE = 64
LDSR_STEPS = 50            # the option's default is 100: halved to keep the run's time
LDSR_SIZE = 256
ZOO_SCALE = 4


def zoo_files():
    """(directory under the models root, file stem, builder(device)) of each
    zoo file: SwinIR-L, Swin2SR at the JAX package's defaults (in the SwinIR
    directory, where the server sniffs it), Real_HAT_GAN_SRx4, DAT x4,
    SCUNet, and LDSR after CompVis' bsr_sr config."""
    from sdwebui_tpu_torch.models import dat, hat, ldsr, scunet, swin2sr, swinir

    return [
        ("SwinIR", "003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN",
         lambda dev: swinir.create_random_swinir(20, dev)),
        ("SwinIR", "Swin2SR_ClassicalSR_X4_64", lambda dev: swin2sr.create_random_swin2sr(21, dev)),
        ("HAT", "Real_HAT_GAN_SRx4", lambda dev: hat.create_random_hat(22, dev)),
        ("DAT", "DAT x4", lambda dev: dat.create_random_dat(23, dev)),
        ("ScuNET", "ScuNET", lambda dev: scunet.create_random_scunet(24, dev)),
        ("LDSR", "model", lambda dev: ldsr.create_random_ldsr(25, dev)),
    ]


def zoo_ln_plan(net) -> int:
    """B5 launches of one forward of a zoo net, from its config: SwinIR and
    Swin2SR the patch norm, two a block and the last norm; HAT two a HAB,
    two an OCAB and the last norm (its patch norm unused, as in JAX); DAT
    before_RG, three a block (norm1, norm2, the gate's), six a spatial
    block's position-bias MLPs and the last norm; SCUNet two a conv-trans
    block; LDSR none."""
    from sdwebui_tpu_torch.models import dat, hat, scunet, swin2sr, swinir

    cfg = net.cfg
    if isinstance(net, scunet.SCUNet):
        return 2 * sum(cfg.config)
    if isinstance(net, dat.DAT):
        return 2 + sum(3 * d + 6 * ((d + 1) // 2) for d in cfg.depths)
    if isinstance(net, hat.HAT):
        return 1 + sum(2 * d + 2 for d in cfg.depths)
    if isinstance(net, (swinir.SwinIR, swin2sr.Swin2SR)):
        return int(cfg.patch_norm) + 2 * sum(cfg.depths) + 1
    return 0


def write_zoo_files(root: str, device) -> dict:
    """Each zoo file written as .safetensors from a seeded net made on the
    card (DAT with its position-bias buffers, LDSR under its checkpoint's
    keys); {stem: (path, the net's config, B5 plan a forward)}."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models import dat, ldsr

    out = {}
    for sub, stem, build in zoo_files():
        net = build(device)
        if isinstance(net, ldsr.LDSR):
            sd = ldsr.ldsr_state_dict(net)
        elif isinstance(net, dat.DAT):
            sd = dat.state_dict_with_buffers(net)
        else:
            sd = net.state_dict()
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, stem + ".safetensors")
        write_safetensors(path, {k: v.detach().cpu().contiguous() for k, v in sd.items()})
        out[stem] = dict(path=path, kind=type(net).__name__, ln_plan=zoo_ln_plan(net),
                         mparams=sum(p.numel() for p in net.parameters()) / 1e6)
        del net, sd
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _timed_forwards(types: tuple, spans: list):
    """(class name, start event, end event) of every forward of a module of
    `types` inside the block, recorded on the current stream."""
    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    open_ = {}

    def pre(module, args):
        if isinstance(module, types):
            open_[id(module)] = torch.cuda.Event(enable_timing=True)
            open_[id(module)].record()

    def post(module, args, result):
        if isinstance(module, types) and id(module) in open_:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans.append((type(module).__name__, open_.pop(id(module)), end))

    hooks = (register_module_forward_pre_hook(pre), register_module_forward_hook(post))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _forward_ms(spans: list) -> dict:
    """{class name: [ms of each forward]} of _timed_forwards' spans."""
    torch.cuda.synchronize()
    out = {}
    for name, start, end in spans:
        out.setdefault(name, []).append(start.elapsed_time(end))
    return out


def check_zoo_nets(files: dict, device) -> dict:
    """Each zoo net's forward on one seeded 64² tile on the card against the
    same file's net on the CPU (f32, TF32 off: max|Δ|/max|ref| <= 1e-4);
    LDSR's UNet (bf16) one step at a 64² latent within UNET_REL_TOL, and its
    VQ decode of that latent (f32, B1 at S = 4096) within 1e-4."""
    from sdwebui_tpu_torch.models import dat, hat, ldsr, scunet, swin2sr, swinir

    loaders = {"SwinIR": swinir.swinir_from_state_dict, "Swin2SR": swin2sr.swin2sr_from_state_dict,
               "HAT": hat.hat_from_state_dict, "DAT": dat.dat_from_state_dict,
               "SCUNet": scunet.scunet_from_state_dict}
    out = {}
    for stem, f in files.items():
        sd = swinir.read_state_dict(f["path"])
        g = torch.Generator().manual_seed(6)
        with torch.inference_mode():
            if f["kind"] == "LDSR":
                cpu, card = ldsr.ldsr_from_state_dict(sd, "cpu"), ldsr.ldsr_from_state_dict(
                    sd, device)
                x = torch.randn((1, 6, ZOO_TILE, ZOO_TILE), generator=g)
                t = torch.full((1,), 981.0)
                ref = cpu.unet(x.bfloat16(), t, None).float()
                got = card.unet(x.to(device).bfloat16(), t.to(device), None).float().cpu()
                z = torch.randn((1, 3, ZOO_TILE, ZOO_TILE), generator=g) * 3
                dref, dgot = cpu.vq.vq_decode(z), card.vq.vq_decode(z.to(device)).cpu()
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                drel = ((dgot - dref).abs().max() / dref.abs().max()).item()
                out[stem] = dict(unet_rel_err=rel, vq_rel_err=drel)
                log(f"{stem} (LDSR): UNet step at a {ZOO_TILE}² latent, card vs CPU "
                    f"max|Δ|/max|ref| {rel:.3e} (bound {UNET_REL_TOL:g}); VQ decode to "
                    f"{4 * ZOO_TILE}² {drel:.3e} (bound {ZOO_REL_TOL:g})")
                if not (rel <= UNET_REL_TOL and drel <= ZOO_REL_TOL):
                    raise AssertionError(f"{stem} on the card disagrees with the CPU")
            else:
                cpu, card = loaders[f["kind"]](sd, "cpu"), loaders[f["kind"]](sd, device)
                x = torch.rand((1, ZOO_TILE, ZOO_TILE, 3), generator=g)
                ref = cpu(x)
                got = card(x.to(device)).cpu()
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                out[stem] = dict(rel_err=rel, out_std=ref.std().item())
                log(f"{stem} ({f['kind']}): one {ZOO_TILE}² tile, card vs CPU max|Δ|/max|ref| "
                    f"{rel:.3e} (bound {ZOO_REL_TOL:g}), output std {ref.std():.3f}")
                if not rel <= ZOO_REL_TOL or got.shape != ref.shape:
                    raise AssertionError(f"{stem} on the card disagrees with the CPU: {rel}")
        del cpu, card, sd
    torch.cuda.empty_cache()
    return out


def phase_zoo(engine, model, phase3: list, root: str, device):
    """4i: the upscaler zoo over HTTP on phase 3's server; returns
    (results, summary)."""
    from sdwebui_tpu_torch.models import dat, hat, ldsr, scunet, swin2sr, swinir
    from sdwebui_tpu_torch.models.unet import UNetModel
    from sdwebui_tpu_torch.models.vae import Decoder
    from sdwebui_tpu_torch.pipeline.processing import setup_img2img_steps
    from sdwebui_tpu_torch.postprocessing.upscalers import (register_model_dirs,
                                                             unregister_upscaler)
    from sdwebui_tpu_torch.utils import images as images_util
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    t0 = time.perf_counter()
    files = write_zoo_files(root, device)
    log(f"wrote the zoo files in {time.perf_counter() - t0:.2f} s: " + json.dumps(
        {k: dict(kind=v["kind"], mparams=round(v["mparams"], 2), ln_plan=v["ln_plan"])
         for k, v in files.items()}))
    names, _ = register_model_dirs(models_root=root, device=device)   # the server's start-up path
    want = [stem for sub in ("SwinIR", "ScuNET", "LDSR", "HAT", "DAT")
            for d, stem, _ in zoo_files() if d == sub]
    want = ["LDSR" if stem == "model" else stem for stem in want]
    if names != want:
        raise AssertionError(f"registered {names}, expected {want}")
    nets = check_zoo_nets(files, device)
    plan = {("LDSR" if s == "model" else s): f for s, f in files.items()}
    timed = (swinir.SwinIR, swin2sr.Swin2SR, hat.HAT, dat.DAT, scunet.SCUNet, UNetModel, Decoder)
    src = phase3[0]["image"]                     # 512²
    lr = images_util.resize(src, (LDSR_SIZE, LDSR_SIZE), "lanczos")
    b64 = {src.shape[0]: phase3[0]["png_b64"],
           LDSR_SIZE: base64.b64encode(encode_png(lr)).decode("ascii")}
    results, plans = [], []

    def extras(url, name, size, label):
        spans = []
        reset_counts()
        with _timed_forwards(timed, spans):
            t0 = time.perf_counter()
            res = _post(f"{url}/extra-single-image", dict(
                image=b64[size], upscaler_1=name, upscaling_resize=ZOO_SCALE))
            dt = time.perf_counter() - t0
        launches = read_counts()
        img, _ = decode_png(base64.b64decode(res["image"]))
        ms = _forward_ms(spans)
        log(f"zoo {label}: {dt:.3f} s, forwards " + json.dumps(
            {k: [round(x, 2) for x in v] if len(v) < 4 else
             dict(n=len(v), median=round(statistics.median(v), 3), total=round(sum(v), 1))
             for k, v in ms.items()}) + f", launches {launches}")
        if img.shape != (ZOO_SCALE * size, ZOO_SCALE * size, 3) or img.std() < 1.0:
            raise AssertionError(f"zoo {label}: image {img.shape}, std {img.std():.3f}")
        # seed: LDSR's noise seed (super_resolution's 0); the other nets draw none
        results.append(dict(route="extra-single-image", label=label, seconds=dt, seed=0,
                            launches=launches, image=img, forward_ms=ms))

    with _server(engine) as url:
        _post(f"{url}/options", {"upscaling_max_images_in_cache": 0, "ldsr_steps": LDSR_STEPS})
        try:
            listed = [u["name"] for u in _post(f"{url}/upscalers")]
            if not set(names) <= set(listed):
                raise AssertionError(f"/upscalers lacks {sorted(set(names) - set(listed))}")
            for name in names:
                f = plan[name]
                size = LDSR_SIZE if f["kind"] == "LDSR" else src.shape[0]
                for i in range(2):
                    extras(url, name, size, f"{name} x{ZOO_SCALE} of {size}², "
                                            f"{'first (loads the file)' if i == 0 else 'repeat'}")
                    if f["kind"] == "LDSR":
                        plans.append(_plan(b1=1, b2=LDSR_STEPS * launch_plan(
                            ldsr.BSR_SR.unet, LDSR_SIZE)))
                    else:
                        plans.append(_plan(b5=f["ln_plan"]))
                _check_repeat(results, -2, -1)
            swin = names[0]
            cfg = model.unet_cfg
            n = setup_img2img_steps(STEPS, HR_DENOISE)[1] + 1
            seconds = []
            with _timed_upscales(seconds):
                r = _request(url, "txt2img", hires_request(2027, swin), _hires_check(swin, 2.0),
                             1024, f"config 3 {swin}")
            results.append(dict(r, upscale_s=seconds[0]))
            plans.append(_plan(b1=3, b2=STEPS * launch_plan(cfg, 64) + n * launch_plan(cfg, 128),
                               b5=STEPS * ln_plan(cfg, 64) + n * ln_plan(cfg, 128)
                               + 2 * clip_ln_plan(model) + plan[swin]["ln_plan"]))
            log(f"config 3 {swin}: the upscale took {seconds[0]:.3f} s of {r['seconds']:.3f} s")
        finally:
            _post(f"{url}/options", {"upscaling_max_images_in_cache": 5})
            for name in names:
                unregister_upscaler(name)
    _check_launches(results, plans)
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(files={k: {x: v[x] for x in ("kind", "mparams", "ln_plan")}
                          for k, v in files.items()},
                   nets=nets, seconds={r["label"]: r["seconds"] for r in results},
                   forward_ms={r["label"]: r.get("forward_ms") for r in results},
                   ldsr_b1_calls=2)
    return results, summary


# config 4's files (bench.py:313-342, 384-396): a rank-16 LoRA over every
# UNet attention projection, a 2-vector embedding (its name the trigger), a
# hypernetwork for SD1.5's context and attention widths, and the tower
LORA_RANK = 16
CN_TRIGGER = "chipemb"
HN_WIDTHS = (768, 320, 640, 1280)
CN_BATCH = 4


def write_network_files(directory: str, model, tower, seed: int = 7) -> dict:
    """The config 4 files in `directory`, made from `seed`: bench.safetensors
    (LoRA, up and down N(0, 0.01²), alpha = rank), chipemb.safetensors
    (N(0, 0.02²), the scale of the CLIP token table), chiphn.safetensors
    (the JAX package's hypernetwork layout, structure 1-2-1, weights
    N(0, 0.01²)) and chipcn.safetensors (`tower` as control_model.* fp16)."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

    g = torch.Generator().manual_seed(seed)
    lora = {}
    for name, w in model.unet.named_parameters():
        mod = name[: -len(".weight")]
        if name.endswith(".weight") and w.dim() == 2 and (".attn1.to_" in mod
                                                          or ".attn2.to_" in mod):
            key = "lora_unet_" + mod.replace(".", "_")
            lora[f"{key}.lora_up.weight"] = torch.randn(w.shape[0], LORA_RANK, generator=g) * 0.01
            lora[f"{key}.lora_down.weight"] = torch.randn(LORA_RANK, w.shape[1],
                                                          generator=g) * 0.01
            lora[f"{key}.alpha"] = torch.tensor(float(LORA_RANK))
    hn = {}
    for width in HN_WIDTHS:
        for tag in "kv":
            for li, (cin, cout) in enumerate(((width, 2 * width), (2 * width, width))):
                hn[f"{width}.{tag}.linear.{li}.weight"] = torch.randn(cin, cout, generator=g) * 0.01
                hn[f"{width}.{tag}.linear.{li}.bias"] = torch.zeros(cout)
    paths = {name: os.path.join(directory, name + ".safetensors")
             for name in ("bench", CN_TRIGGER, "chiphn", "chipcn")}
    write_safetensors(paths["bench"], lora)
    width = model.conditioner.cfg.width
    write_safetensors(paths[CN_TRIGGER], {"emb_params": torch.randn(2, width, generator=g) * 0.02})
    write_safetensors(paths["chiphn"], hn, metadata={"activation_func": "linear"})
    write_safetensors(paths["chipcn"], {"control_model." + k: v.half()
                                        for k, v in tower.state_dict().items()})
    log(f"config 4 files: LoRA {len(lora) // 3} modules rank {LORA_RANK}, embedding "
        f"{CN_TRIGGER!r} (2 vectors), hypernetwork widths {HN_WIDTHS}, tower "
        f"{os.path.getsize(paths['chipcn']) / 1e9:.3f} GB fp16")
    return paths


def config4_request(seed: int, hint_png: str, **unit) -> dict:
    """BASELINE config 4 as the JAX bench's lora_cn leg (bench.py:378-396):
    config 1 at batch 4 with the LoRA tag and the embedding's trigger, and
    one canny unit at weight 1 on the 16-px grid."""
    return dict(SD15_BASE, seed=seed, batch_size=CN_BATCH,
                prompt=f"{SD15_BASE['prompt']}, {CN_TRIGGER} <lora:bench:0.8>",
                controlnet_units=[dict(dict(model="chipcn", image=hint_png, module="canny",
                                            weight=1.0), **unit)])


@contextlib.contextmanager
def _timed_merges(first: list, cached: list):
    """The seconds of each LoRA merge (extra_networks._merge) and of each
    activation that found its merge cached (apply_to_model without one)."""
    from sdwebui_tpu_torch.networks import extra_networks

    real_merge, real_apply = extra_networks._merge, extra_networks.apply_to_model
    merges = []

    def merge(*args):
        t0 = time.perf_counter()
        out = real_merge(*args)
        torch.cuda.synchronize()
        merges.append(time.perf_counter() - t0)
        return out

    def apply(*args):
        n, t0 = len(merges), time.perf_counter()
        out = real_apply(*args)
        if len(merges) == n:
            cached.append(time.perf_counter() - t0)
        else:
            first.append(merges[-1])
        return out
    extra_networks._merge, extra_networks.apply_to_model = merge, apply
    try:
        yield
    finally:
        extra_networks._merge, extra_networks.apply_to_model = real_merge, real_apply


@contextlib.contextmanager
def _network_registries(engine, directory: str):
    """The LoRA, hypernetwork, ControlNet and embedding registries over
    `directory` (as --lora-dir, --hypernetwork-dir, --controlnet-dir and
    --embeddings-dir set them), back to their defaults afterwards."""
    from sdwebui_tpu_torch.networks.extra_networks import DEFAULT_LORA_DIRS, set_lora_dirs
    from sdwebui_tpu_torch.networks.hypernetwork import (DEFAULT_HYPERNETWORK_DIR,
                                                         set_hypernetwork_dirs)
    from sdwebui_tpu_torch.networks.textual_inversion import DEFAULT_EMBEDDINGS_DIR
    from sdwebui_tpu_torch.pipeline import control

    set_lora_dirs([directory])
    set_hypernetwork_dirs([directory])
    control.set_model_dirs([directory])
    engine.embeddings_dir = directory
    engine.refresh_embeddings()
    try:
        yield
    finally:
        set_lora_dirs(DEFAULT_LORA_DIRS)
        set_hypernetwork_dirs([DEFAULT_HYPERNETWORK_DIR])
        control.set_model_dirs([control.DEFAULT_CONTROLNET_DIR])
        engine.embeddings_dir = DEFAULT_EMBEDDINGS_DIR
        engine.refresh_embeddings()
        engine.sd_model.network_cache.clear()


def phase_config4(engine, model, phase3: dict, directory: str, tower):
    """4e: BASELINE config 4 on the phase-3 server; returns (results, info)."""
    from sdwebui_tpu_torch.pipeline import control
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    cfg, size = model.unet_cfg, SD15_BASE["width"]
    latent = size // 8
    modules = {"unet": model.unet, "clip": model.conditioner.model}
    before = {m: {k: v.clone() for k, v in mod.state_dict().items()}
              for m, mod in modules.items()}
    write_network_files(directory, model, tower)
    grid = torch.zeros((size, size, 3), dtype=torch.uint8)
    grid[::16] = 255
    grid[:, ::16] = 255
    hint_png = base64.b64encode(encode_png(grid.numpy())).decode("ascii")

    def check(params, seed):
        _sd15_check(params, seed)
        for want in ("<lora:bench:0.8>", f'TI hashes: "{CN_TRIGGER}: '):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    def plan(tower_calls: int = STEPS, batch_clip: int = 1) -> dict:
        return _plan(b1=1, b2=STEPS * launch_plan(cfg, latent) + tower_calls * launch_plan(
            cfg, latent, False), b5=STEPS * ln_plan(cfg, latent) + tower_calls * ln_plan(
            cfg, latent, False) + batch_clip * clip_ln_plan(model))

    first, cached, results, plans = [], [], [], []
    with _network_registries(engine, directory):
        with _server(engine) as url, _timed_merges(first, cached):
            _post(f"{url}/txt2img", dict(config4_request(1, hint_png), steps=2, batch_size=1))
            first.clear()       # the warm-up merged the set; the timed runs merge anew
            cached.clear()
            engine.sd_model.network_cache.clear()
            for label in ("config 4", "config 4 repeat"):       # (a), (b)
                results.append(_request(url, "txt2img", config4_request(1234, hint_png), check,
                                        size, label))
                plans.append(plan())
            _check_repeat(results, 0, 1)
            if len(first) != 1 or len(cached) != 1:
                raise AssertionError(f"merges {first}, cached activations {cached}: the "
                                     "repeated tag set must merge once")
            log(f"config 4: LoRA merge {first[0]:.3f} s the first time, the cached set "
                f"{cached[0] * 1e3:.2f} ms; s/request {results[0]['seconds']:.3f}, "
                f"{results[1]['seconds']:.3f}")
            results.append(_request(url, "txt2img", config4_request(                # (c)
                1234, hint_png, guidance_end=0.5), check, size, "config 4 guidance_end 0.5"))
            plans.append(plan(tower_calls=STEPS // 2))
            body = dict(SD15_BASE, seed=1234, batch_size=1,                          # (d)
                        prompt=SD15_BASE["prompt"] + " <hypernet:chiphn:1.0>")
            results.append(_request(url, "txt2img", body, _sd15_check, size, "hypernetwork"))
            plans.append(plan(tower_calls=0))
            results.append(_request(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1),
                                    _sd15_check, size, "tagless"))                   # (e)
            plans.append(plan(tower_calls=0))
            detect = _post(url.replace("/sdapi/v1", "/controlnet/detect"), {          # (f)
                "controlnet_module": "canny", "controlnet_input_images": [phase3["png_b64"]],
                "controlnet_processor_res": size})
        _check_launches(results, plans)
        tagless = results[-1]["image"].astype(int)
        delta = int(abs(tagless - phase3["image"].astype(int)).max())
        changed = [k for m, mod in modules.items() for k, v in mod.state_dict().items()
                   if not torch.equal(v, before[m][k])]
        log(f"tagless request after config 4: max|Δ| {delta} uint8 levels from phase 3's image "
            f"(bound {REPEAT_TOL}); {len(changed)} base tensors changed")
        if delta > REPEAT_TOL or changed:
            raise AssertionError(f"the base model changed: {delta} levels, {changed[:4]}")
        (edges,) = [decode_png(base64.b64decode(b))[0] for b in detect["images"]]
        share = float((edges > 0).mean())
        log(f"/controlnet/detect canny on a phase-3 PNG: {edges.shape}, {share:.4f} edge pixels")
        if edges.shape[:2] != (size, size) or set(edges.ravel().tolist()) - {0, 255} \
                or not 0 < share < 0.5:
            raise AssertionError(f"canny over /controlnet/detect: {edges.shape}, {share}")
        # the tower alone at config 4's 8 CFG rows
        (live, _), = control._resident.values()
        g = torch.Generator(device=engine.device).manual_seed(3)
        x = torch.randn((2 * CN_BATCH, 4, latent, latent), generator=g,
                        device=engine.device).to(torch.bfloat16)
        t = torch.full((2 * CN_BATCH,), 500.0, device=engine.device)
        ctx = torch.randn((2 * CN_BATCH, 77, cfg.context_dim), generator=g,
                          device=engine.device).to(torch.bfloat16)
        hint = _grid_hint(size, 2 * CN_BATCH, engine.device)
        with torch.inference_mode():
            tower_ms = cuda_ms(lambda: live(x, t, ctx, hint), iters=5, hide_host=False)
        log(f"ControlNet tower per CFG call at {2 * CN_BATCH} rows, {latent}² latent: "
            f"{tower_ms:.2f} ms")
        info = dict(merge_s=first[0], cached_activation_s=cached[0], tower_ms_per_cfg_call=tower_ms,
                    tagless_delta=delta, detect_edge_share=share,
                    profile=phase_profile(engine, config4_request(1234, hint_png), "config 4",
                                          wall=statistics.median(
                                              r["seconds"] for r in results[:2])))
    return results, info


# phase 4f: the hybrid UNets and the depth half of config 4
P2P_IMAGE_CFG = 1.5
DPT_REL_TOL = 1e-4        # max|Δ| / max|ref|, the MiDaS tower on the card vs the CPU, f32
DETECT_RES = (512, 384)   # processor_res on a 512² PNG: as it is, and INTER_AREA's shrink


def midas_ln_plan() -> int:
    """B5 launches of one MiDaS forward: two per ViT block, f32 (its
    577-token attention takes the plain path, so no B2)."""
    from sdwebui_tpu_torch.models.midas import DPTConfig

    return 2 * DPTConfig().vit_layers


def write_annotator_files(directory: str, device, seed: int = 5) -> dict:
    """The model annotators' files at the published widths, made from
    `seed`: ControlNetHED.safetensors (widths 64..512, fp32) and
    dpt_hybrid-midas-501f0c75.safetensors (the DPT-hybrid, fp16)."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.hed import create_random_hed
    from sdwebui_tpu_torch.models.midas import create_random_dpt

    paths = {"hed": os.path.join(directory, "ControlNetHED.safetensors"),
             "depth_midas": os.path.join(directory, "dpt_hybrid-midas-501f0c75.safetensors")}
    write_safetensors(paths["hed"], {k: v.cpu() for k, v in
                                     create_random_hed(seed, device).state_dict().items()})
    write_safetensors(paths["depth_midas"], {k: v.half().cpu() for k, v in
                                             create_random_dpt(seed, device).state_dict().items()})
    return paths


@contextlib.contextmanager
def _rows_seen(unet, rows: list):
    """Appends the batch rows of every call of `unet` to `rows`."""
    handle = unet.register_forward_pre_hook(lambda module, args: rows.append(args[0].shape[0]))
    try:
        yield
    finally:
        handle.remove()


def phase_hybrid(engine, model, phase3: dict, directory: str, device, tower):
    """4f: (a) SD2-depth from an fp16 file through --ckpt, (b) the
    inpainting model, (c) instruct-pix2pix, (d) /controlnet/detect with the
    model annotators, (e) config 4 with a depth_midas unit on phase 2's
    tower; returns (results, info)."""
    import copy

    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.pipeline import annotators
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.pipeline.sd_model import (create_random_sd2_depth,
                                                     create_random_sd15)
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png

    init_png = phase3["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = SD15_BASE["width"]
    latent = size // 8
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    midas = midas_ln_plan()
    results, plans, info = [], [], {}

    def i2i_plan(m, b1, rows_midas=0):
        return _plan(b1=b1, b2=calls * launch_plan(m.unet_cfg, latent),
                     b5=calls * ln_plan(m.unet_cfg, latent) + clip_ln_plan(m) + rows_midas * midas)

    def check_i2i(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    # (a) SD2-depth: an ldm fp16 file served through --ckpt
    t0 = time.perf_counter()
    path = os.path.join(directory, "random-sd2-depth-fp16.safetensors")
    depth = create_random_sd2_depth(seed=21, device=device)
    write_safetensors(path, {k: v.half() for k, v in load.ldm_state_dict(depth).items()})
    del depth
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_d = Engine(device=device, ckpt=path, ckpt_dirs=[directory],
                      hash_cache=os.path.join(directory, "hashes.json"))
    loaded = engine_d.sd_model
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"SD2-depth file {os.path.getsize(path) / 1e9:.3f} GB written in {t_write:.2f} s, "
        f"loaded (sha256 and file → card) in {t_load:.2f} s: {loaded.kind}, "
        f"{loaded.unet_cfg.in_channels}-channel UNet, depth tower {loaded.is_depth}")
    if not (loaded.kind == "sd2" and loaded.is_depth and loaded.unet_cfg.in_channels == 5):
        raise AssertionError("the SD2-depth file did not load as the depth variant")
    with _server(engine_d) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2))
        for label in ("SD2-depth img2img", "SD2-depth img2img repeat"):
            results.append(_request(url, "img2img", dict(base, seed=1234), check_i2i, size, label))
            plans.append(i2i_plan(loaded, b1=2, rows_midas=1))
        results.append(_request(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1),
                                _sd15_check, size, "SD2-depth txt2img"))
        plans.append(_plan(b1=1, b2=STEPS * launch_plan(loaded.unet_cfg, latent),
                           b5=STEPS * ln_plan(loaded.unet_cfg, latent) + clip_ln_plan(loaded)))
    _check_repeat(results, 0, 1)
    if results[2]["image"].std() < 1.0:
        raise AssertionError("the SD2-depth txt2img image is flat")
    tower_d = loaded.depth_model
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.rand((1, 3, 384, 384), generator=g, device=device) * 2 - 1
    with torch.inference_mode():
        reset_counts()
        card = tower_d(x)
        torch.cuda.synchronize()
        counted = read_counts()
        cpu = copy.deepcopy(tower_d).to("cpu")(x.cpu())
        dpt_ms = cuda_ms(lambda: tower_d(x), iters=5, hide_host=False)
        dpt_kernels = kernel_times(lambda: tower_d(x))
    dpt_rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    log(f"MiDaS DPT-hybrid at 384², f32: card vs CPU max|Δ|/max|ref| {dpt_rel:.3e} (bound "
        f"{DPT_REL_TOL:g}), {dpt_ms:.2f} ms a forward, launches {counted}; device ms by class "
        + json.dumps({k: round(v, 2) for k, v in dpt_kernels["by_class"].items()})
        + "; top kernels " + json.dumps([(n[:60], round(t, 2)) for n, t in dpt_kernels["top"]]))
    if not dpt_rel <= DPT_REL_TOL or counted != _plan(b5=midas):
        raise AssertionError(f"MiDaS on the card: {dpt_rel}, launches {counted}")
    info["sd2_depth"] = dict(file_write_s=t_write, load_s=t_load, dpt_rel_err=dpt_rel,
                             dpt_ms=dpt_ms, dpt_launches=counted, dpt_kernels=dpt_kernels)
    del engine_d, loaded, tower_d, cpu, card
    os.remove(path)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the inpainting model (9 channels): B1 = the init encode, the
    # masked image's encode and the decode
    mask, mask_png = _rect_mask_png(size)
    inpaint = create_random_sd15(seed=9, device=device, in_channels=9)
    with _server(Engine(model=inpaint, device=device)) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2))
        results.append(_request(url, "img2img", dict(
            base, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
            inpaint_full_res=False), check_i2i, size, "inpainting model"))
        plans.append(i2i_plan(inpaint, b1=3))
    _check_overlay(results[-1]["image"], init, mask)
    del inpaint
    torch.cuda.empty_cache()

    # (c) instruct-pix2pix (8 channels) at image_cfg_scale 1.5 (3 CFG rows)
    # and 1.0 (the plain 2-row CFG with the init latent as c_concat)
    p2p = create_random_sd15(seed=8, device=device, in_channels=8)
    rows = {}
    with _server(Engine(model=p2p, device=device)) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2, image_cfg_scale=P2P_IMAGE_CFG))
        for scale in (P2P_IMAGE_CFG, 1.0):
            seen = rows.setdefault(scale, [])
            with _rows_seen(p2p.unet, seen):
                results.append(_request(url, "img2img", dict(base, seed=1234,
                                                             image_cfg_scale=scale),
                                        check_i2i, size, f"instruct-pix2pix image_cfg {scale}"))
            plans.append(i2i_plan(p2p, b1=2))
    p2p_delta = float(abs(results[-2]["image"].astype(int) - results[-1]["image"].astype(int))
                      .mean())
    log(f"instruct-pix2pix: UNet rows per call {sorted(set(rows[P2P_IMAGE_CFG]))} at "
        f"image_cfg_scale {P2P_IMAGE_CFG}, {sorted(set(rows[1.0]))} at 1.0; the images "
        f"mean|Δ| {p2p_delta:.2f} levels apart")
    if set(rows[P2P_IMAGE_CFG]) != {3} or set(rows[1.0]) != {2} or not p2p_delta > 0:
        raise AssertionError(f"instruct-pix2pix CFG rows {rows}, delta {p2p_delta}")
    del p2p
    torch.cuda.empty_cache()

    # (d) /controlnet/detect with the model annotators on the phase-3 server
    prev_dirs = list(annotators._model_dirs)
    annotator_dir = os.path.join(directory, "Annotators")
    os.makedirs(annotator_dir)
    write_annotator_files(annotator_dir, device)
    annotators.set_annotator_dirs([annotator_dir])
    detect = {}
    try:
        with _server(engine) as url:
            for module in ("depth_midas", "hed"):
                for res in DETECT_RES:
                    reset_counts()
                    t0 = time.perf_counter()
                    out = _post(url.replace("/sdapi/v1", "/controlnet/detect"), {
                        "controlnet_module": module, "controlnet_input_images": [init_png],
                        "controlnet_processor_res": res})
                    dt = time.perf_counter() - t0
                    counted = read_counts()
                    (hint,) = [decode_png(base64.b64decode(b))[0] for b in out["images"]]
                    planned = _plan(b5=midas if module == "depth_midas" else 0)
                    log(f"/controlnet/detect {module} at processor_res {res}: {dt:.3f} s, "
                        f"hint {hint.shape}, std {hint.std():.2f}, launches {counted}")
                    if hint.shape[:2] != (res, res) or hint.std() < 1.0 or counted != planned:
                        raise AssertionError(f"{module} at {res}: {hint.shape}, std "
                                             f"{hint.std()}, launches {counted} != {planned}")
                    detect[f"{module}_{res}"] = dict(seconds=dt, hint_std=float(hint.std()))
        info["detect"] = detect

        # (e) config 4 with a depth_midas unit on phase 2's tower
        network_dir = os.path.join(directory, "networks")
        os.makedirs(network_dir)
        write_network_files(network_dir, model, tower)
        cfg = model.unet_cfg
        with _network_registries(engine, network_dir), _server(engine) as url:
            results.append(_request(url, "txt2img", config4_request(
                1234, init_png, module="depth_midas"), _sd15_check, size,
                "config 4 with a depth_midas unit"))
            plans.append(_plan(b1=1, b2=STEPS * (launch_plan(cfg, latent) + launch_plan(cfg, latent, False)),
                               b5=STEPS * (ln_plan(cfg, latent) + ln_plan(cfg, latent, False))
                               + clip_ln_plan(model) + midas))
    finally:
        annotators.set_annotator_dirs(prev_dirs)
    _check_launches(results, plans)
    info["seconds"] = {r["label"]: r["seconds"] for r in results}
    # the VAE encodes at 512² (f32): each img2img request's, and the
    # inpainting model's masked image
    info["f32_encodes_512"] = sum(r["route"] == "img2img" for r in results) + 1
    return results, info


# ---------------------------------------------------------------------------
# phase 4h: job control and face restoration
# ---------------------------------------------------------------------------

PROGRESS_MS = 50.0        # median round trip of /progress during a generation
LOGIT_TOL = 1e-4          # max|Δ| of CodeFormer's code logits, B5 against plain LayerNorm
FACE_IMAGE_TOL = 2        # uint8 levels: a face net's image, kernel (or card) vs plain (CPU)
FACE_REL_TOL = 1e-3       # RetinaFace's heads, card vs CPU (the JAX test's rtol)
FACE_WEIGHT = 0.5         # code_former_weight's default
FACE_LN = 19              # B5 launches of one CodeFormer face: 9 x (norm1, norm2) + idx_pred
#: config 1 at batch 4, two iterations: iteration 2's seeds are phase 3's batch-4 request's
JOB = dict(SD15_BASE, seed=95, batch_size=4, n_iter=2,
           override_settings={"show_progress_type": "Full"})


def write_face_files(directory: str, device, seed: int = 9) -> dict:
    """Seeded face nets at the published widths, where the server's
    --gfpgan-models-path / --codeformer-models-path look: GFPGANv1.4-clean
    (512, channel multiplier 2) and CodeFormer (nf 64, ch_mult
    (1, 2, 2, 4, 4, 8), 9 layers of 512, codebook 1024) as ``params_ema``
    files, and RetinaFace-R50 as facexlib's."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.codeformer import create_random_codeformer
    from sdwebui_tpu_torch.models.gfpgan import create_random_gfpgan
    from sdwebui_tpu_torch.models.retinaface import create_random_retinaface

    paths = {}
    for i, (name, make, sub, fn, prefix) in enumerate((
            ("GFPGAN", create_random_gfpgan, "GFPGAN", "GFPGANv1.4.safetensors", "params_ema."),
            ("CodeFormer", create_random_codeformer, "Codeformer",
             "codeformer-v0.1.0.safetensors", "params_ema."),
            ("RetinaFace", create_random_retinaface, "", "detection_Resnet50_Final.safetensors",
             ""))):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
        paths[name] = os.path.join(directory, sub, fn)
        net = make(seed + i, device)
        write_safetensors(paths[name], {prefix + k: v for k, v in net.state_dict().items()})
        del net
    return paths


def _get_raw(url, body=None):
    """(round-trip ms, raw answer): the timing leaves out the JSON decode."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
    return (time.perf_counter() - t0) * 1e3, raw


def _watched_job(url, root, body, act) -> tuple:
    """A txt2img in a thread while this one polls /progress and
    /internal/progress; act(progress answer) runs at each poll of the job.
    Returns (seconds, answer, launches, polls)."""
    from sdwebui_tpu_torch.utils.png import decode_png

    out = {}

    def worker():
        t0 = time.perf_counter()
        out["res"] = _post(f"{url}/txt2img", body)
        out["seconds"] = time.perf_counter() - t0

    polls, shapes = [], {}
    reset_counts()
    thread = threading.Thread(target=worker)
    thread.start()
    while thread.is_alive():
        ms, raw = _get_raw(f"{url}/progress")
        p = json.loads(raw)
        q = json.loads(_get_raw(f"{root}/internal/progress",
                                {"id_task": "chip_smoke", "live_preview": False})[1])
        # each answer counts only while it saw the job (it may end between them)
        if p["state"]["job"] and q["active"]:
            pid = q["id_live_preview"]
            if p["current_image"] and pid not in shapes:
                shapes[pid] = decode_png(base64.b64decode(p["current_image"]))[0].shape
            polls.append(dict(ms=ms, progress=p["progress"], internal=q["progress"], id=pid,
                              job_no=p["state"]["job_no"], step=p["state"]["sampling_step"],
                              preview=p["current_image"] is not None))
        if p["state"]["job"]:
            act(p)
        time.sleep(0.02)
    thread.join()
    launches = read_counts()
    if "res" not in out:
        raise AssertionError("the watched txt2img request failed")
    out["shapes"] = sorted(set(shapes.values()))
    return out, launches, polls


def _job_control(url, root, model, phase3: list) -> dict:
    """4h (a): a batch-4, n_iter-2 txt2img with Full previews, polled; a
    /skip in iteration 1; a second request stopped by /interrupt."""
    from sdwebui_tpu_torch.utils.png import decode_png

    sent = {}

    def skip_once(p):
        st = p["state"]
        if "skip" not in sent and st["job_no"] == 0 and st["sampling_step"] >= 5:
            _post(f"{url}/skip", {})
            sent["skip"] = (st["job_no"], st["sampling_step"])

    size = JOB["width"]
    job, launches, polls = _watched_job(url, root, JOB, skip_once)
    images = [decode_png(base64.b64decode(b))[0] for b in job["res"]["images"]]
    live = _post(f"{root}/internal/progress", {"id_task": "chip_smoke", "live_preview": True})
    head, b64 = live["live_preview"].split(",", 1)
    last = decode_png(base64.b64decode(b64))[0]
    per_call = launch_plan(model.unet_cfg, 64)
    b2 = launches["flash_attention_packed"]
    ms = sorted(q["ms"] for q in polls)
    info = dict(seconds=job["seconds"], skip_at=sent.get("skip"), polls=len(polls),
                progress_ms_median=statistics.median(ms) if ms else None,
                progress_ms_p90=ms[int(0.9 * (len(ms) - 1))] if ms else None,
                progress_ms_max=ms[-1] if ms else None, preview_shapes=job["shapes"],
                unet_calls=b2 / per_call, launches=launches)
    delta = int(abs(images[-1].astype(int) - phase3[1]["image"].astype(int)).max())
    log(f"4h (a) job control: {job['seconds']:.3f} s, skip at {sent.get('skip')}, "
        f"{len(polls)} polls, /progress median {info['progress_ms_median']:.2f} ms, p90 "
        f"{info['progress_ms_p90']:.2f}, max {info['progress_ms_max']:.2f} ms (bound "
        f"{PROGRESS_MS}), previews {job['shapes']}, ids {polls[0]['id']}..{polls[-1]['id']}, "
        f"UNet calls {b2 / per_call:g}, iteration 2 vs phase 3's seed-99 batch: max|Δ| "
        f"{delta} levels")
    seq = [q["progress"] for q in polls]
    inner = [q["internal"] for q in polls]
    ids = [q["id"] for q in polls]
    if sent.get("skip", (None,))[0] != 0:
        raise AssertionError(f"no /skip landed in iteration 1: {sent}")
    if len(images) != 8 or any(im.shape != (size, size, 3) for im in images):
        raise AssertionError(f"{len(images)} images after a skip, expected 8 of {size}²")
    if head != "data:image/png;base64" or not (last == images[-1]).all():
        raise AssertionError("/internal/progress's preview is not the job's last image")
    if not (b2 % per_call == 0 and 20 * per_call <= b2 < 40 * per_call):
        raise AssertionError(f"B2 launches {b2}: iteration 1 not cut short, or 2 not whole")
    if delta > REPEAT_TOL:
        raise AssertionError(f"iteration 2 differs from phase 3's batch by {delta} levels")
    if seq != sorted(seq) or inner != sorted(inner) or ids != sorted(ids) or ids[-1] <= ids[0]:
        raise AssertionError(f"progress fell or no preview came: {seq}, {inner}, {ids}")
    grid, one = (2 * size, 2 * size, 3), (size, size, 3)
    if grid not in job["shapes"] or not set(job["shapes"]) <= {grid, one}:
        raise AssertionError(f"preview shapes {job['shapes']}: no 2x2 grid of {size}² images")
    if not info["progress_ms_median"] < PROGRESS_MS:
        raise AssertionError(f"/progress median {info['progress_ms_median']:.1f} ms")

    def interrupt_once(p):
        if "interrupt" not in sent and p["state"]["sampling_step"] >= 5:
            _post(f"{url}/interrupt", {})
            sent["interrupt"] = (p["state"]["job_no"], p["state"]["sampling_step"])

    stopped, _, _ = _watched_job(url, root, JOB, interrupt_once)
    n = len(stopped["res"]["images"])
    info.update(interrupted_seconds=stopped["seconds"], interrupted_images=n,
                interrupt_at=sent.get("interrupt"))
    log(f"4h (a) interrupt at {sent.get('interrupt')}: {n} images in "
        f"{stopped['seconds']:.3f} s (the skipped job: {job['seconds']:.3f} s)")
    if n != 4 or not stopped["seconds"] < 0.75 * job["seconds"]:
        raise AssertionError(f"an interrupted job gave {n} images in {stopped['seconds']} s")
    return info


def _restore_requests(url, model, phase3: list) -> list:
    """4h (b): config 1 with restore_faces (CodeFormer at FACE_WEIGHT), twice."""
    body = dict(SD15_BASE, seed=1234, batch_size=1, restore_faces=True, override_settings={
        "face_restoration_model": "CodeFormer", "code_former_weight": FACE_WEIGHT})

    def check(params, seed):
        _sd15_check(params, seed)
        if "Face restoration: CodeFormer" not in params:
            raise AssertionError(f"infotext lacks the face restorer: {params!r}")

    t0 = time.perf_counter()
    _post(f"{url}/txt2img", dict(body, steps=2))          # loads CodeFormer
    log(f"4h (b) warm-up with the CodeFormer load: {time.perf_counter() - t0:.3f} s")
    results = [_request(url, "txt2img", body, check, body["width"], label="restore_faces")
               for _ in range(2)]
    _check_repeat(results, 0, 1)
    delta = int(abs(results[0]["image"].astype(int) - phase3[0]["image"].astype(int)).max())
    log(f"4h (b) restore_faces: {results[0]['seconds']:.3f} and {results[1]['seconds']:.3f} "
        f"s/request against phase 3's {phase3[0]['seconds']:.3f}; max|Δ| {delta} levels from "
        "phase 3's image of the seed")
    if delta <= REPEAT_TOL:
        raise AssertionError("restore_faces left phase 3's image as it was")
    _check_launches(results, [_plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                                    b5=STEPS * ln_plan(model.unet_cfg, 64)
                                    + clip_ln_plan(model) + FACE_LN)] * 2)
    return results


def _face_extras(url, phase3: list) -> dict:
    """4h (c): the Extras GFPGAN (visibility 1) and CodeFormer (0.5) stages."""
    from sdwebui_tpu_torch.utils.png import decode_png

    reset_counts()
    t0 = time.perf_counter()
    res = _post(f"{url}/extra-single-image", dict(
        image=phase3[0]["png_b64"], upscaler_1="None", upscaling_resize=1,
        gfpgan_visibility=1.0, codeformer_visibility=0.5, codeformer_weight=FACE_WEIGHT))
    dt = time.perf_counter() - t0
    launches = read_counts()
    out = decode_png(base64.b64decode(res["image"]))[0]
    delta = float(abs(out.astype(int) - phase3[0]["image"].astype(int)).mean())
    log(f"4h (c) extras GFPGAN 1 + CodeFormer 0.5: {dt:.3f} s (both nets read from their "
        f"files), mean|Δ| {delta:.2f} levels from the input, launches {launches}")
    if out.shape != phase3[0]["image"].shape or not delta > 1.0:
        raise AssertionError(f"extras faces: {out.shape}, mean|Δ| {delta}")
    _check_launches([dict(launches=launches)], [_plan(b5=FACE_LN)])
    return dict(route="extra-single-image", label="extras faces", seconds=dt, batch=1,
                launches=launches)


def _paste_region(device, image, paths) -> dict:
    """4h (d): RetinaFace at 512², then a CodeFormer restore through a
    fixed-landmark detector: 0 levels outside the pasted face's mask,
    changed inside; the host ms of align + paste-back."""
    from sdwebui_tpu_torch.models.retinaface import detect_faces, load_retinaface
    from sdwebui_tpu_torch.postprocessing import faces
    from sdwebui_tpu_torch.utils import images as images_util

    net = load_retinaface(paths["RetinaFace"], device)
    found = detect_faces(net, image)
    x = torch.from_numpy(image.transpose(2, 0, 1).astype("float32"))[None].to(device)
    with torch.inference_mode():
        retina_ms = cuda_ms(lambda: net(x), hide_host=False)
    h, w = image.shape[:2]
    lm = faces.FACE_TEMPLATE_512 * (w / 1024) + w / 32       # a face half as wide, upper left
    faces.set_face_detector(lambda im: [lm])
    try:
        out = faces.restore_faces(image, "CodeFormer", weight=FACE_WEIGHT, device=device)
    finally:
        faces.set_face_detector(None)
    crop = 512                                             # CodeFormer's face size
    m = faces.similarity_transform(lm, faces.FACE_TEMPLATE_512 * (crop / 512))
    mask = faces.paste_mask(m, crop, (w, h))
    diff = abs(out.astype(int) - image.astype(int)).max(axis=-1)
    outside, inside = int(diff[mask == 0].max()), float(diff[mask > 0].mean())

    def align_paste():
        aligned = faces.warp(image, m, (crop, crop))
        back = faces.warp(aligned, faces.invert_affine(m), (w, h))
        return images_util.composite(back, image, faces.paste_mask(m, crop, (w, h)))

    host = host_ms(align_paste)
    log(f"4h (d) RetinaFace-R50 at {w}²: {len(found)} faces (random weights), "
        f"{retina_ms:.3f} ms a forward; fixed-landmark restore: outside the mask max|Δ| "
        f"{outside} levels, inside mean|Δ| {inside:.2f}; align + paste-back {host:.1f} host ms")
    if outside != 0 or not inside > 1.0:
        raise AssertionError(f"paste-back wrong: outside {outside}, inside {inside}")
    return dict(retinaface_ms=retina_ms, faces_found=len(found), align_paste_host_ms=host,
                outside_max=outside, inside_mean=inside)


def _to_u8(img) -> "torch.Tensor":
    return ((img.float().cpu() + 1.0) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8)


def _face_nets(paths, device, image) -> dict:
    """4h (e, f): CodeFormer's forward with B5 against plain LayerNorm on the
    card (logits, flips only at near ties, image), GFPGAN's and
    RetinaFace's on the card against the CPU; ms per forward at 512² and
    one profiled forward of each."""
    from sdwebui_tpu_torch.loader.load import read_checkpoint
    from sdwebui_tpu_torch.models.codeformer import codeformer_from_state_dict
    from sdwebui_tpu_torch.models.gfpgan import gfpgan_from_state_dict
    from sdwebui_tpu_torch.models.retinaface import retinaface_from_state_dict
    from sdwebui_tpu_torch.ops import norms
    from sdwebui_tpu_torch.utils import images as images_util

    info = {}
    face = images_util.resize(image, (512, 512), "lanczos")      # the nets' face size
    x = (torch.from_numpy(face.transpose(2, 0, 1).astype("float32"))[None] / 127.5 - 1.0)
    xd = x.to(device)
    with torch.inference_mode():
        cf = codeformer_from_state_dict(read_checkpoint(paths["CodeFormer"]), device)
        reset_counts()
        cf(xd, w=FACE_WEIGHT)
        torch.cuda.synchronize()
        cf_launches = read_counts()["layer_norm"]
        lq, feats, logits = cf.encode(xd)
        with norms.forced_plain():
            lq_p, feats_p, logits_p = cf.encode(xd)
            plain_ms = cuda_ms(lambda: cf(xd, w=FACE_WEIGHT), hide_host=False)
        dl = (logits - logits_p).abs().max().item()
        top2 = logits_p.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1])
        flips = logits.argmax(-1) != logits_p.argmax(-1)
        flip_margins = margin[flips].tolist()
        img = _to_u8(cf.decode(lq, feats, logits, w=FACE_WEIGHT))
        img_p = _to_u8(cf.decode(lq_p, feats_p, logits_p, w=FACE_WEIGHT))
        img_delta = int((img.int() - img_p.int()).abs().max())
        cf_ms = cuda_ms(lambda: cf(xd, w=FACE_WEIGHT), hide_host=False)
        cf_prof = kernel_times(lambda: cf(xd, w=FACE_WEIGHT))
        del cf, lq, feats, lq_p, feats_p
        torch.cuda.empty_cache()
    info["codeformer"] = dict(ms=cf_ms, plain_ms=plain_ms, logits_max_abs_err=dl,
                              flips=len(flip_margins), flip_margins=flip_margins,
                              image_max_delta=img_delta, layer_norm_launches=cf_launches,
                              profile=cf_prof)
    log(f"4h (e) CodeFormer 512²: logits max|Δ| B5 vs plain {dl:.3e} (bound {LOGIT_TOL:g}), "
        f"{len(flip_margins)} index flips (top-2 margins {flip_margins[:8]}), image max|Δ| "
        f"{img_delta} levels, B5 launches {cf_launches}; {cf_ms:.3f} ms a face (plain "
        f"LayerNorm {plain_ms:.3f} ms); by class {cf_prof['by_class']}, top {cf_prof['top'][:4]}")
    if dl > LOGIT_TOL or any(mg > 2 * dl for mg in flip_margins):
        raise AssertionError(f"CodeFormer logits: max|Δ| {dl}, flips at margins {flip_margins}")
    if not flip_margins and img_delta > FACE_IMAGE_TOL:
        raise AssertionError(f"CodeFormer image differs by {img_delta} levels")
    if cf_launches != FACE_LN:
        raise AssertionError(f"CodeFormer launched B5 {cf_launches} times, planned {FACE_LN}")

    for name, load, compare in (("GFPGAN", gfpgan_from_state_dict, "image"),
                                ("RetinaFace", retinaface_from_state_dict, "heads")):
        sd = read_checkpoint(paths[name])
        inp = x if name == "GFPGAN" else torch.from_numpy(
            face.transpose(2, 0, 1).astype("float32"))[None]
        with torch.inference_mode():
            ref = load(sd, "cpu")(inp)
            net = load(sd, device)
            got = net(inp.to(device))
            torch.cuda.synchronize()
            xin = inp.to(device)
            ms = cuda_ms(lambda: net(xin), hide_host=False)
            prof = kernel_times(lambda: net(xin))
        if compare == "image":
            err = int((_to_u8(got).int() - _to_u8(ref).int()).abs().max())
            ok = err <= FACE_IMAGE_TOL
        else:
            err = max((g.cpu() - r).abs().max().item() / max(r.abs().max().item(), 1.0)
                      for g, r in zip(got, ref))
            ok = err <= FACE_REL_TOL
        info[name.lower()] = dict(ms=ms, card_vs_cpu=err, profile=prof)
        log(f"4h (e) {name} 512²: card vs CPU {compare} {err:.3g} (bound "
            f"{FACE_IMAGE_TOL if compare == 'image' else FACE_REL_TOL:g}), {ms:.3f} ms a "
            f"forward; by class {prof['by_class']}, top {prof['top'][:4]}")
        if not ok:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {err}")
        del net, got, ref
        torch.cuda.empty_cache()
    return info


def phase_faces(engine, model, phase3: list, directory: str, device):
    """4h: job control and face restoration on the phase-3 server, with
    seeded face nets at the published widths in `directory`, registered
    as server/__main__ registers --gfpgan-models-path and
    --codeformer-models-path.  Returns (results, info)."""
    from sdwebui_tpu_torch.postprocessing import faces

    t0 = time.perf_counter()
    paths = write_face_files(directory, device)
    log(f"wrote the face nets' files in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{n} {os.path.getsize(p) / 2 ** 20:.0f} MiB" for n, p in paths.items()))
    faces.set_model_dirs("GFPGAN", [os.path.dirname(paths["GFPGAN"])])
    faces.set_model_dirs("CodeFormer", [os.path.dirname(paths["CodeFormer"])])
    info = {}
    try:
        with _server(engine) as url:
            root = url.rsplit("/sdapi/v1", 1)[0]
            restorers = [r["name"] for r in _post(f"{url}/face-restorers")]
            if restorers != ["None", "CodeFormer", "GFPGAN"]:
                raise AssertionError(f"/face-restorers: {restorers}")
            info["job_control"] = _job_control(url, root, model, phase3)
            results = _restore_requests(url, model, phase3)
            results.append(_face_extras(url, phase3))
        info["paste"] = _paste_region(device, phase3[0]["image"], paths)
        info["nets"] = _face_nets(paths, device, phase3[0]["image"])
        info["restore_s"] = [r["seconds"] for r in results[:2]]
        info["phase3_s"] = phase3[0]["seconds"]
    finally:
        for name, dirs in faces.DEFAULT_DIRS.items():
            faces.set_model_dirs(name, dirs)
    gc.collect()
    torch.cuda.empty_cache()
    return results, info


# ---------------------------------------------------------------------------
# phase 4l: training and interrogation
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8           # phase 4l: steps of each training run
TRAIN_SAVE_EVERY = 4
TRAIN_SIZE = 512
GRAD_REL_TOL = 1e-4       # a TI step's gradient, card vs CPU, tiny model, f32, TF32 off
RESUME_REL_TOL = 1e-5     # a resumed step vs the unbroken run's, on the card
BOORU_TOL = 1e-4          # DeepDanbooru's scores, card vs CPU
BOORU_TAGS = 1000
CAPTION_MAX, CAPTION_MIN = 16, 8     # BLIP's new tokens in phase 4l


def write_training_pngs(directory: str, count: int = 4, size: int = TRAIN_SIZE,
                        seed: int = 21) -> None:
    """`count` smooth seeded PNGs of size² (the first RGBA, its top half
    opaque), captioned by their names."""
    from sdwebui_tpu_torch.utils.png import encode_png

    os.makedirs(directory, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    for i in range(count):
        low = torch.rand((1, 3, size // 16, size // 16), generator=g)
        img = (F.interpolate(low, size=(size, size), mode="bicubic", align_corners=False)
               .clamp(0, 1)[0].permute(1, 2, 0) * 255).to(torch.uint8)
        if i == 0:
            alpha = torch.full((size, size, 1), 40, dtype=torch.uint8)
            alpha[: size // 2] = 255
            img = torch.cat([img, alpha], dim=-1)
        with open(os.path.join(directory, f"{i}-red fox {i}.png"), "wb") as f:
            f.write(encode_png(img.numpy()))


class _StepSpy:
    """Wraps a trainer's step function: each step's seconds (synchronised),
    loss and the kernel launches inside it, and the inputs and outputs of
    the step `keep` (0-based)."""

    def __init__(self, module, factory: str, keep: int | None = None):
        self.module, self.factory, self.keep = module, factory, keep
        self.real = getattr(module, factory)
        self.seconds, self.losses, self.launches, self.kept = [], [], [], None

    def __enter__(self):
        spy = self

        def make(*a, **kw):
            step, init = spy.real(*a, **kw)

            def timed(*args, **kwargs):
                i = len(spy.seconds)
                if i == spy.keep:
                    spy.kept = {"inputs": args, "emb_before": args[0].detach().clone()}
                torch.cuda.synchronize()
                counts = read_counts()
                t0 = time.perf_counter()
                out = step(*args, **kwargs)
                torch.cuda.synchronize()
                spy.seconds.append(time.perf_counter() - t0)
                after = read_counts()
                spy.launches.append({k: after[k] - counts[k] for k in after})
                loss = out[2] if isinstance(out, tuple) else out
                spy.losses.append(float(loss))
                if i == spy.keep:
                    spy.kept["emb_after"] = args[0].detach().clone()
                    spy.kept["lr"] = args[1].param_groups[0]["lr"]
                return out

            timed.loss = getattr(step, "loss", None)
            return timed, init

        setattr(self.module, self.factory, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self.real)


class _PreviewSpy:
    """Counts the launches of a trainer's preview (a txt2img)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.launches = []

    def __enter__(self):
        def preview(*a, **kw):
            torch.cuda.synchronize()
            before = read_counts()
            self.real(*a, **kw)
            torch.cuda.synchronize()
            after = read_counts()
            self.launches.append({k: after[k] - before[k] for k in after})

        setattr(self.module, self.name, preview)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _check_steps(spy: _StepSpy, label: str) -> dict:
    import math

    if len(spy.losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in spy.losses):
        raise AssertionError(f"{label}: losses {spy.losses}")
    inside = {k: sum(launch[k] for launch in spy.launches) for k in spy.launches[0]}
    if any(inside[k] for k in ("flash_attention", "flash_attention_packed", "layer_norm")):
        raise AssertionError(f"{label}: kernels launched inside the steps: {inside}")
    step_s = sorted(spy.seconds[1:])[len(spy.seconds[1:]) // 2]
    log(f"{label}: {TRAIN_STEPS} steps, losses {[round(x, 5) for x in spy.losses]}, "
        f"s per step {step_s:.4f} (first {spy.seconds[0]:.3f}), launches inside {inside}")
    return dict(losses=spy.losses, step_s=step_s, first_step_s=spy.seconds[0],
                launches_inside=inside)


def _preview_plan(model) -> dict:
    """The preview's launches: a 256² txt2img of 8 Euler a steps."""
    return _plan(b1=1, b2=8 * launch_plan(model.unet_cfg, 32),
                 b5=8 * ln_plan(model.unet_cfg, 32) + clip_ln_plan(model))


def _ti_resume(model, data: str, directory: str) -> dict:
    """An unbroken 5-step run against a 4-step run saved with its .optim:
    one step from the saved embedding and state, on the unbroken run's
    fifth inputs, lands where the unbroken run's fifth step did."""
    from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
    from sdwebui_tpu_torch.training import textual_inversion as ti
    from sdwebui_tpu_torch.training.step import set_lr
    from sdwebui_tpu_torch.utils.options import opts

    kw = dict(n_vectors=2, learn_rate="0.005", width=TRAIN_SIZE, height=TRAIN_SIZE, seed=3)
    with opts.override({"save_optimizer_state": True, "training_write_csv_every": 0,
                        "save_training_settings_to_txt": False}):
        saved = os.path.join(directory, "resume.safetensors")
        four, _ = ti.train_embedding_from_dir(model, "resume", data, steps=4, save_path=saved,
                                              **kw)
        with _StepSpy(ti, "make_ti_train_step", keep=4) as spy:
            ti.train_embedding_from_dir(model, "resume", data, steps=5, **kw)
    before = spy.kept["emb_before"].cpu()
    if float((before - four.vec).abs().max() / four.vec.abs().max()) > RESUME_REL_TOL:
        raise AssertionError("the unbroken run's fourth step differs from the saved run's")
    step, init = ti.make_ti_train_step(model, n_vectors=2)
    emb = read_state_dict(saved)["emb_params"].to(model.device).requires_grad_(True)
    optimizer = init(emb)
    ti.load_optim_state(optimizer, emb, saved)
    set_lr(optimizer, spy.kept["lr"])
    step(emb, optimizer, *spy.kept["inputs"][2:])
    want = spy.kept["emb_after"]
    rel = float((emb.detach() - want).abs().max() / want.abs().max())
    count = int(optimizer.state[emb]["step"])
    log(f"4l (a) resume: the saved count {read_state_dict(saved + '.optim')['leaf0'].tolist()}, "
        f"the resumed step's max|Δ|/max|ref| vs the unbroken run {rel:.2e} "
        f"(bound {RESUME_REL_TOL}), Adam count after {count}")
    if rel > RESUME_REL_TOL or count != 5:
        raise AssertionError(f"resumed step: rel {rel}, count {count}")
    return dict(resume_rel=rel)


def _grad_check(device) -> dict:
    """One TI step's loss and embedding gradient on a tiny model, on the
    card against the CPU (both plain: training_ctx), f32, TF32 off; and
    the kernels' and the option's refusals."""
    import copy

    from sdwebui_tpu_torch.ops import layer_norm as ln_mod
    from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd
    from sdwebui_tpu_torch.training import textual_inversion as ti
    from sdwebui_tpu_torch.training.step import training_ctx
    from sdwebui_tpu_torch.utils.options import opts

    cpu = create_tiny_sd(5, "cpu")
    card = copy.deepcopy(cpu).to(device)
    g = torch.Generator().manual_seed(7)
    latents, noise = torch.randn((2, 4, 8, 8), generator=g), torch.randn((2, 4, 8, 8), generator=g)
    emb0 = torch.randn((2, cpu.conditioner.cfg.width), generator=g) * 0.01
    toks, pos = ti.prepare_tokens(cpu.conditioner.tokenizer, "a photo of {} in snow", 2)
    toks = torch.as_tensor(toks, dtype=torch.long)[None].repeat(2, 1)
    pos, t = torch.tensor([pos, pos]), torch.tensor([120, 870])
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        emb = emb0.to(dev).clone().requires_grad_(True)
        step, _ = ti.make_ti_train_step(model, n_vectors=2)
        reset_counts()
        with training_ctx():
            loss = step.loss(emb, latents.to(dev), noise.to(dev), t.to(dev), toks.to(dev),
                             pos.to(dev), torch.ones_like(latents).to(dev))
        loss.backward()
        out[name] = (loss.item(), emb.grad.cpu(), read_counts())
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = float((out["card"][1] - out["cpu"][1]).abs().max() / out["cpu"][1].abs().max())
    log(f"4l (c) TI step on the card vs the CPU: loss rel {loss_rel:.2e}, gradient "
        f"max|Δ|/max|ref| {grad_rel:.2e} (bound {GRAD_REL_TOL}), card launches "
        f"{out['card'][2]}")
    if loss_rel > GRAD_REL_TOL or grad_rel > GRAD_REL_TOL or any(out["card"][2].values()):
        raise AssertionError(f"card step: loss rel {loss_rel}, grad rel {grad_rel}")
    x = torch.randn((4, 768), device=device, requires_grad=True)
    try:
        ln_mod.layer_norm(x, None, None)
        raise AssertionError("layer_norm returned on a tensor that requires grad")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    with opts.override({"training_xattention_optimizations": True}):
        try:
            with training_ctx():
                pass
            raise AssertionError("training_xattention_optimizations did not raise")
        except NotImplementedError as e:
            if "training_xattention_optimizations" not in str(e):
                raise
    return dict(loss_rel=loss_rel, grad_rel=grad_rel)


def write_interrogate_files(root: str, device, seed: int = 13) -> dict:
    """The interrogators' files at the published widths, from `seed`, fp16,
    in the reference's layout under `root`: DeepDanbooru (the published
    plan, BOORU_TAGS tags), CLIP ViT-L/14 (HF CLIPModel keys), BLIP
    ViT-B/16 384² with a BERT-base decoder and its vocab.txt, two category
    files."""
    import dataclasses

    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models import blip, deepbooru
    from sdwebui_tpu_torch.models.clip import CLIPTextModel
    from sdwebui_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from sdwebui_tpu_torch.models.configs import CLIP_L
    from sdwebui_tpu_torch.models.layers import reset_random

    paths = {k: os.path.join(root, *v) for k, v in (
        ("deepbooru", ("models", "torch_deepdanbooru")), ("clip", ("models", "clip_vision")),
        ("blip", ("models", "BLIP")), ("categories", ("interrogate",)))}
    for d in paths.values():
        os.makedirs(d, exist_ok=True)
    tags = [f"tag_{i}" if i % 100 else f"rating:r{i}" for i in range(BOORU_TAGS)]
    sd = deepbooru.random_state_dict(tags, seed)
    torch.save({k: (v.half() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()},
               os.path.join(paths["deepbooru"], "chip.pt"))
    g = torch.Generator(device=device).manual_seed(seed)
    vision = CLIPVisionModel(CLIPVisionConfig(), device=device, dtype=torch.float32)
    vision.reset_random(g)
    text = CLIPTextModel(dataclasses.replace(CLIP_L, projection_dim=768), device=device,
                         dtype=torch.float32)
    reset_random(text, g)
    clip = {f"vision_model.{k}": v for k, v in vision.state_dict().items()
            if k != "visual_projection.weight"}
    clip["visual_projection.weight"] = vision.visual_projection.weight
    clip.update({f"text_model.{k}": v for k, v in text.state_dict().items()
                 if k != "text_projection.weight"})
    clip["text_projection.weight"] = text.text_projection.weight
    write_safetensors(os.path.join(paths["clip"], "clip.safetensors"),
                      {k: v.half() for k, v in clip.items()})
    del vision, text, clip
    write_safetensors(os.path.join(paths["blip"], "blip.safetensors"),
                      blip.random_state_dict(blip.BlipConfig(), seed))
    vocab = [f"w{i}" for i in range(30524)]
    for i, t in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"), (102, "[SEP]"), (1037, "a"),
                 (3861, "picture"), (1997, "of"), (30522, "[DEC]"), (30523, "[ENC]")):
        vocab[i] = t
    with open(os.path.join(paths["blip"], "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    with open(os.path.join(paths["categories"], "artists.txt"), "w") as f:
        f.write("\n".join(f"an artist {i}" for i in range(6)))
    with open(os.path.join(paths["categories"], "flavors.top3.txt"), "w") as f:
        f.write("\n".join(f"a flavor {i}" for i in range(8)))
    return paths


def _interrogate(url, paths: dict, phase3: list, device) -> dict:
    """4l (d): the tagger and the CLIP interrogator with BLIP over HTTP on a
    phase-3 PNG, each caption against the CPU port's on the same files, the
    tagger's scores card vs CPU, ms per forward and B5 launches."""
    from sdwebui_tpu_torch.models import blip, clip_vision, deepbooru
    from sdwebui_tpu_torch.postprocessing import interrogate as interrogators

    image = phase3[0]["image"]
    info, captions = {}, {}
    for model in ("deepdanbooru", "clip"):
        reset_counts()
        t0 = time.perf_counter()
        captions[model] = _post(f"{url}/interrogate", {"image": phase3[0]["png_b64"],
                                                       "model": model})["caption"]
        info[f"{model}_s"] = time.perf_counter() - t0
        info[f"{model}_launches"] = read_counts()
    booru_path = os.path.join(paths["deepbooru"], "chip.pt")
    card_net = deepbooru.load_deepbooru(booru_path, device)
    cpu_net = deepbooru.load_deepbooru(booru_path, "cpu")
    card_scores, cpu_scores = deepbooru.scores(card_net, image), deepbooru.scores(cpu_net, image)
    info["booru_max_abs_err"] = float(abs(card_scores - cpu_scores).max())
    cpu_tags = deepbooru.tag_image(cpu_net, image, threshold=0.5, alpha_sort=True)
    x = torch.rand((1, 3, 512, 512), device=device)
    with torch.inference_mode():
        info["booru_ms"] = cuda_ms(lambda: card_net(x), iters=3, warmup=1, hide_host=False)
    del card_net, cpu_net
    clip_path = os.path.join(paths["clip"], "clip.safetensors")
    found = interrogators.find_blip_model(paths["blip"])
    cpu_clip = interrogators.ClipInterrogator(clip_path, paths["categories"], device="cpu")
    cpu_blip = interrogators.BlipCaptioner(*found, device="cpu")
    cpu_caption = cpu_clip.interrogate(image, captioner=cpu_blip)
    card_blip = interrogators.BlipCaptioner(*found, device=device)
    card_clip = interrogators.ClipInterrogator(clip_path, paths["categories"], device=device)
    px = torch.from_numpy(clip_vision.preprocess(image, 224)).to(device)
    bx = torch.from_numpy(blip.preprocess(image, 384)).to(device)
    with torch.inference_mode():
        info["clip_vit_ms"] = cuda_ms(lambda: card_clip.vision(px), iters=3, warmup=1,
                                      hide_host=False)
        info["blip_vit_ms"] = cuda_ms(lambda: card_blip.net.vision(bx), iters=3, warmup=1,
                                      hide_host=False)
    prompt = [card_blip.cfg.bos_token_id] + card_blip.tok.encode(card_blip.PROMPT)
    ids = cpu_blip.net.generate(torch.from_numpy(blip.preprocess(image, 384)), prompt,
                                CAPTION_MAX, CAPTION_MIN)
    decode_steps = len(ids) - len(prompt)
    n_categories = len(cpu_clip.categories)
    planned = _plan(b5=(2 * 24 + 2) + n_categories * (2 * 12 + 2) + (2 * 12 + 1)
                    + decode_steps * (1 + 3 * 12 + 1))
    log(f"4l (d) interrogate: deepdanbooru {captions['deepdanbooru'][:80]!r}..., clip "
        f"{captions['clip'][:120]!r}; tagger scores card vs CPU max|Δ| "
        f"{info['booru_max_abs_err']:.2e} (bound {BOORU_TOL}); ms per forward: DeepDanbooru "
        f"512² {info['booru_ms']:.2f}, CLIP ViT-L/14 {info['clip_vit_ms']:.2f}, BLIP ViT-B/16 "
        f"384² {info['blip_vit_ms']:.2f}; clip launches {info['clip_launches']}, planned "
        f"{planned} ({decode_steps} decode steps)")
    if captions["deepdanbooru"] != cpu_tags or captions["clip"] != cpu_caption:
        raise AssertionError(f"captions differ from the CPU port's: {captions} vs "
                             f"{cpu_tags!r}, {cpu_caption!r}")
    if info["booru_max_abs_err"] > BOORU_TOL:
        raise AssertionError(f"DeepDanbooru's scores differ by {info['booru_max_abs_err']}")
    if info["clip_launches"] != planned or any(info["deepdanbooru_launches"].values()):
        raise AssertionError(f"interrogate launches {info['clip_launches']} != {planned}")
    return info


def _preprocess(url, paths: dict, directory: str) -> dict:
    """4l (e): the preprocess route (split, focal crop, flip, DeepDanbooru
    captions) against the CPU port's pass on the same three PNGs."""
    from sdwebui_tpu_torch.training import preprocess
    from sdwebui_tpu_torch.utils.png import encode_png

    src = os.path.join(directory, "pre_src")
    os.makedirs(src)
    g = torch.Generator().manual_seed(31)
    for name, (h, w) in (("wide", (320, 560)), ("tall", (640, 448)), ("square", (512, 512))):
        low = torch.rand((1, 3, h // 32, w // 32), generator=g)
        img = (F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
               .clamp(0, 1)[0].permute(1, 2, 0) * 255).to(torch.uint8)
        with open(os.path.join(src, f"{name}.png"), "wb") as f:
            f.write(encode_png(img.numpy()))
    body = {"process_src": src, "process_dst": os.path.join(directory, "pre_card"),
            "process_width": 512, "process_height": 512, "process_split": True,
            "process_split_threshold": 1.5, "process_flip": True, "process_focal_crop": True,
            "process_caption_deepbooru": True}
    t0 = time.perf_counter()
    res = _post(f"{url}/preprocess", body)
    seconds = time.perf_counter() - t0
    ref = preprocess.preprocess_dir(src, os.path.join(directory, "pre_cpu"), width=512,
                                    height=512, split=True, split_threshold=1.5, flip=True,
                                    focal_crop=True,
                                    caption_deepbooru=True, device="cpu",
                                    deepbooru_dir=paths["deepbooru"])
    card = sorted(os.listdir(body["process_dst"]))
    if card != sorted(os.listdir(os.path.join(directory, "pre_cpu"))) or \
            len(res["outputs"]) != len(ref):
        raise AssertionError(f"preprocess files {card} vs the CPU's")
    for f in card:
        with open(os.path.join(body["process_dst"], f), "rb") as a, \
                open(os.path.join(directory, "pre_cpu", f), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"preprocess output {f} differs from the CPU port's")
    log(f"4l (e) preprocess: {res['info']} in {seconds:.2f} s, {len(card)} files equal to the "
        "CPU port's")
    return dict(seconds=seconds, files=len(card))


def phase_training(engine, model, phase3: list, directory: str, device):
    """4l: training and interrogation on the phase-3 server.  Returns
    (results, info)."""
    from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
    from sdwebui_tpu_torch.networks import hypernetwork as hn_mod
    from sdwebui_tpu_torch.training import hypernetwork as hn_train
    from sdwebui_tpu_torch.training import textual_inversion as ti
    from sdwebui_tpu_torch.utils.options import opts

    data = os.path.join(directory, "data")
    write_training_pngs(data)
    prev_emb_dir = engine.embeddings_dir
    engine.embeddings_dir = os.path.join(directory, "embeddings")
    hn_mod.set_hypernetwork_dirs([os.path.join(directory, "hypernetworks")])
    t0 = time.perf_counter()
    paths = write_interrogate_files(os.path.join(directory, "interrogate_root"), device)
    log(f"4l: wrote the interrogators' files in {time.perf_counter() - t0:.2f} s")
    info, results = {}, []
    saved = {k: opts.data.get(k) for k in ("interrogate_clip_max_length",
                                           "interrogate_clip_min_length")}
    train = {"data_root": data, "steps": TRAIN_STEPS, "training_width": TRAIN_SIZE,
             "training_height": TRAIN_SIZE, "create_image_every": TRAIN_STEPS,
             "use_weight": True, "preview_prompt": "a photo of a red fox"}
    try:
        with _server(engine) as url, _interrogate_server(engine, paths) as iurl:
            # (a) textual inversion
            _post(f"{url}/create/embedding", {"name": "chip-ti", "num_vectors_per_token": 2})
            torch.cuda.reset_peak_memory_stats()
            with _StepSpy(ti, "make_ti_train_step", keep=0) as spy, \
                    _PreviewSpy(ti, "_save_preview") as previews:
                t0 = time.perf_counter()
                res = _post(f"{url}/train/embedding", dict(
                    train, embedding_name="chip-ti", num_vectors_per_token=2,
                    learn_rate="0.005", save_embedding_every=TRAIN_SAVE_EVERY))
                info["ti_route_s"] = time.perf_counter() - t0
            info["ti_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            info["ti"] = _check_steps(spy, "4l (a) textual inversion")
            vec = read_state_dict(os.path.join(engine.embeddings_dir, "chip-ti.safetensors"))[
                "emb_params"]
            moved = float((vec - spy.kept["emb_before"].cpu()).abs().max())
            if moved < 1e-3:
                raise AssertionError(f"the embedding did not move ({moved})")
            if previews.launches != [_preview_plan(model)]:
                raise AssertionError(f"preview launches {previews.launches} != "
                                     f"{_preview_plan(model)}")
            log(f"4l (a) {res['info']}; route {info['ti_route_s']:.2f} s, peak "
                f"{info['ti_peak_gib']:.2f} GiB, embedding moved {moved:.4f}, preview "
                f"launches {previews.launches[0]}")
            prompt = dict(SD15_BASE, prompt="a photo of chip-ti in the snow", steps=8,
                          batch_size=1, seed=404)
            ti_runs = [_request(url, "txt2img", prompt, _sd15_check, 512, label="4l TI")
                       for _ in range(2)]
            if "chip-ti" not in ti_runs[0]["infotext"]:
                raise AssertionError(f"infotext lacks the embedding: {ti_runs[0]['infotext']!r}")
            _check_repeat(ti_runs, 0, 1)
            planned = _plan(b1=1, b2=8 * launch_plan(model.unet_cfg, 64),
                            b5=8 * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
            _check_launches(ti_runs, [planned] * 2)
            results += ti_runs
            info["resume"] = _ti_resume(model, data, directory)
            # (b) hypernetwork, dropout on
            _post(f"{url}/create/hypernetwork", {"name": "chip-hn",
                                                 "enable_sizes": [768, 320, 640, 1280]})
            with _StepSpy(hn_train, "make_hn_train_step") as spy, \
                    _PreviewSpy(hn_train, "_save_hn_preview") as previews:
                t0 = time.perf_counter()
                res = _post(f"{url}/train/hypernetwork", dict(
                    train, hypernetwork_name="chip-hn", learn_rate="0.0001",
                    layer_structure=[1, 2, 2, 1], use_dropout=True,
                    save_hypernetwork_every=TRAIN_SAVE_EVERY))
                info["hn_route_s"] = time.perf_counter() - t0
            info["hn"] = _check_steps(spy, "4l (b) hypernetwork")
            if previews.launches != [_preview_plan(model)]:
                raise AssertionError(f"HN preview launches {previews.launches}")
            log(f"4l (b) {res['info']}; route {info['hn_route_s']:.2f} s")
            hn_runs = [_request(url, "txt2img", dict(prompt, prompt=p), _sd15_check, 512,
                                label=label)
                       for p, label in (("a fox <hypernet:chip-hn:1>", "4l HN"),
                                        ("a fox", "4l no HN"))]
            if abs(hn_runs[0]["image"].astype(int) - hn_runs[1]["image"].astype(int)).max() == 0:
                raise AssertionError("the trained hypernetwork changed nothing")
            _check_launches(hn_runs, [planned] * 2)
            results += hn_runs
            # (c) the gradient on the card
            info["grad"] = _grad_check(device)
            # (d) interrogate, (e) preprocess
            _post(f"{url}/options", {"interrogate_clip_max_length": CAPTION_MAX,
                                     "interrogate_clip_min_length": CAPTION_MIN})
            info["interrogate"] = _interrogate(iurl, paths, phase3, device)
            info["preprocess"] = _preprocess(iurl, paths, directory)
    finally:
        opts.data.update(saved)
        engine.embeddings_dir = prev_emb_dir
        engine.refresh_embeddings()
        hn_mod.set_hypernetwork_dirs([hn_mod.DEFAULT_HYPERNETWORK_DIR])
    gc.collect()
    torch.cuda.empty_cache()
    return results, info


@contextlib.contextmanager
def _interrogate_server(engine, paths: dict):
    """A server around `engine` whose interrogate and preprocess routes read
    `paths`; yields its /sdapi/v1 URL."""
    from sdwebui_tpu_torch.server.api import make_server

    server = make_server(engine, "127.0.0.1", 0, interrogate_dirs=paths)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def phase_checkpoint(model, device, phase3: dict, ckpt_dir: str):
    """4a: the random SD1.5 and a second one (seed 1, fp16) as checkpoint
    files, served by a checkpoint Engine; returns (engine, results, info)."""
    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.options import opts

    first = os.path.join(ckpt_dir, "random-sd15-seed0.safetensors")
    second = os.path.join(ckpt_dir, "random-sd15-seed1-fp16.safetensors")
    t0 = time.perf_counter()
    write_safetensors(first, load.ldm_state_dict(model), metadata={"format": "pt"})
    other = create_random_sd15(seed=1, device=device)
    write_safetensors(second, {k: v.half() for k, v in load.ldm_state_dict(other).items()})
    del other
    torch.cuda.empty_cache()
    gb = os.path.getsize(first) / 1e9
    log(f"wrote {os.path.basename(first)} ({gb:.3f} GB, UNet bf16, VAE and CLIP fp32) and "
        f"{os.path.basename(second)} ({os.path.getsize(second) / 1e9:.3f} GB, fp16) in "
        f"{time.perf_counter() - t0:.2f} s")

    reads = []
    real_read = load.read_checkpoint

    def counted_read(path, *a, **k):
        reads.append(path)
        return real_read(path, *a, **k)
    load.read_checkpoint = counted_read
    opts.set("sd_checkpoints_limit", 2)
    t0 = time.perf_counter()
    engine = Engine(device=device, ckpt=first, ckpt_dirs=[ckpt_dir],
                    hash_cache=os.path.join(ckpt_dir, "hashes.json"))
    sha = engine.registry.find(os.path.basename(first)).calculate_sha256(engine.hash_cache)
    t_hash = time.perf_counter() - t0
    loaded = engine.sd_model                       # file → the model on the card
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0 - t_hash
    swaps = []
    real_reload = engine.reload_checkpoint

    def timed_reload(name=None):
        t = time.perf_counter()
        real_reload(name)
        torch.cuda.synchronize()
        swaps.append(time.perf_counter() - t)
    engine.reload_checkpoint = timed_reload

    plan = _plan(b1=1, b2=STEPS * launch_plan(loaded.unet_cfg, 64),
                 b5=STEPS * ln_plan(loaded.unet_cfg, 64) + clip_ln_plan(loaded))
    body = dict(SD15_BASE, seed=1234, batch_size=1)

    def check(params, seed):
        _sd15_check(params, seed)
        if f"Model hash: {sha[:10]}" not in params:
            raise AssertionError(f"infotext lacks the file's hash {sha[:10]}: {params!r}")

    results = []
    with _server(engine) as url:
        results.append(_request(url, "txt2img", body, check, 512, "from the file"))
        first_image_s = t_load + results[0]["seconds"]
        delta = int(abs(results[0]["image"].astype(int) - phase3["image"].astype(int)).max())
        log(f"load: sha256 {t_hash:.2f} s, file → card {t_load:.2f} s ({t_load / gb:.3f} s/GB), "
            f"file → first image {first_image_s:.2f} s; the image is {delta} uint8 levels "
            f"from phase 3's (bound {REPEAT_TOL})")
        if delta > REPEAT_TOL:
            raise AssertionError(f"the file's image differs from phase 3's by {delta}")
        _post(f"{url}/options", {"sd_model_checkpoint": os.path.basename(second)})
        results.append(_request(url, "txt2img", body, _sd15_check, 512, "the second file"))
        other_diff = float(abs(results[1]["image"].astype(int)
                               - results[0]["image"].astype(int)).mean())
        n_reads = len(reads)
        results.append(_request(url, "txt2img", dict(body, override_settings={
            "sd_model_checkpoint": os.path.basename(first)}), check, 512, "swapped back"))
        back = int(abs(results[2]["image"].astype(int) - phase3["image"].astype(int)).max())
        listed = sorted(m["filename"] for m in _post(f"{url}/sd-models"))
    log(f"second checkpoint: mean|Δ| {other_diff:.2f} levels from the first; swap back "
        f"{back} levels from phase 3 with {len(reads) - n_reads} file reads; swaps "
        + ", ".join(f"{t:.3f} s" for t in swaps) + f"; sd-models {listed}")
    if not other_diff > 1.0:
        raise AssertionError("the second checkpoint gave the first one's image")
    if back > REPEAT_TOL or len(reads) != n_reads:
        raise AssertionError(f"swap back: {back} levels from phase 3, "
                             f"{len(reads) - n_reads} file reads")
    if listed != sorted([first, second]):
        raise AssertionError(f"sd-models lists {listed}")
    load.read_checkpoint = real_read
    _check_launches(results, [plan] * 3)
    engine.reload_checkpoint = real_reload
    info = dict(file_gb=gb, sha256_s=t_hash, load_s=t_load, load_s_per_gb=t_load / gb,
                first_image_s=first_image_s, swap_s=swaps, file_reads=reads)
    return engine, results, info


def phase_samplers(engine):
    """4b: one request per sampler name on the loaded model."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import prepare_sampler
    from sdwebui_tpu_torch.sampling.solvers import build_restart_plan

    model = engine.sd_model
    per_call = launch_plan(model.unet_cfg, 64)
    results = []
    with _server(engine) as url:
        names = [s["name"] for s in _post(f"{url}/samplers")]
        for name in names:
            body = dict(SD15_BASE, sampler_name=name, steps=SAMPLER_STEPS, seed=77,
                        batch_size=1)

            def check(params, seed, name=name):
                if f"Sampler: {name}," not in params or f"Seed: {seed}," not in params:
                    raise AssertionError(f"infotext lacks sampler {name!r}: {params!r}")
            r = _request(url, "txt2img", body, check, 512, f"sampler {name!r}")
            _, spec, sigmas, _ = prepare_sampler(model, GenerationParams(
                sampler_name=name, steps=SAMPLER_STEPS), SAMPLER_STEPS)
            n = len(build_restart_plan(sigmas)[0]) if spec.name == "restart" else len(sigmas) - 1
            calls = spec.model_calls(n)
            b2 = r["launches"]["flash_attention_packed"]
            if r["image"].std() < 1.0:
                raise AssertionError(f"{name}: the image is flat")
            if calls is None:
                ok = b2 > 0 and b2 % per_call == 0
                calls = b2 // per_call
            else:
                ok = b2 == calls * per_call
            if not ok or r["launches"]["flash_attention"] != 1:
                raise AssertionError(f"{name}: launches {r['launches']} for {calls} model calls "
                                     f"of {per_call} B2 launches each")
            results.append(dict(r, sampler=name, model_calls=calls))
    log("s/request by sampler at 512², 8 steps: " + json.dumps(
        {r["sampler"]: [round(r["seconds"], 3), r["model_calls"]] for r in results}))
    return results


def phase_sdxl_unet(base, refiner, device):
    from sdwebui_tpu_torch.pipeline.processing import _decode_u8

    g = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((2, 4, 128, 128), generator=g, device=device).to(bf16)
    t = torch.tensor([500.0, 500.0], device=device)
    out = {}
    for label, m in (("base", base), ("refiner", refiner)):
        cfg = m.unet_cfg
        ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=device).to(bf16)
        y = torch.randn((2, cfg.adm_in_channels), generator=g, device=device)
        out[label] = _unet_step(f"SDXL {label} B=2 128x128 bf16", m.unet, cfg, 128, x, t,
                                ctx, y)
    # the base's step with an SDXL ControlNet tower (label_emb on y)
    tower = random_tower(base.unet_cfg, 12, device)
    ctx = torch.randn((2, 77, base.unet_cfg.context_dim), generator=g, device=device).to(bf16)
    y = torch.randn((2, base.unet_cfg.adm_in_channels), generator=g, device=device)
    out["base_controlnet"] = _unet_step("SDXL base + ControlNet B=2 128x128 bf16", base.unet,
                                        base.unet_cfg, 128, x, t, ctx, y, tower=tower,
                                        hint=_grid_hint(1024, 2, device))
    del tower
    torch.cuda.empty_cache()
    # the SDXL VAE at 1024²: the bf16 decode and the fp32 retry dtype
    z = torch.randn((1, 4, 128, 128), generator=g, device=device)
    decoded = {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u8, bad = _decode_u8(base, z, dtype)
            dt = time.perf_counter() - t0
        if bad or u8.shape != (1, 1024, 1024, 3):
            raise AssertionError(f"SDXL VAE decode in {dtype}: non-finite={bad}, {u8.shape}")
        decoded[str(dtype)[6:]] = (u8.astype(int), dt)
    diff = abs(decoded["bfloat16"][0] - decoded["float32"][0])
    out["vae_decode"] = dict(bf16_s=decoded["bfloat16"][1], f32_s=decoded["float32"][1],
                             max_abs_diff=int(diff.max()), mean_abs_diff=float(diff.mean()))
    log(f"SDXL VAE decode 1024²: bf16 {decoded['bfloat16'][1]:.3f} s, fp32 "
        f"{decoded['float32'][1]:.3f} s, both finite; bf16 vs fp32 max|Δ| {diff.max()} "
        f"mean|Δ| {diff.mean():.3f} uint8 levels (bound {VAE_MEAN_DIFF_TOL:g})")
    if not diff.mean() <= VAE_MEAN_DIFF_TOL:
        raise AssertionError(f"SDXL VAE bf16 decode is {diff.mean()} levels from fp32")
    return out


def sdxl_request(seed: int, refiner_title: str) -> dict:
    """BASELINE config 5 as the JAX bench runs it (bench.py:478-489)."""
    return dict(prompt="a photograph of an astronaut riding a horse",
                negative_prompt="blurry", seed=seed, steps=STEPS, cfg_scale=7.0,
                sampler_name="DPM++ 2M", scheduler="Karras", width=1024, height=1024,
                batch_size=1, refiner_checkpoint=refiner_title,
                refiner_switch_at=SDXL_SWITCH_AT)


def phase_sdxl_serve(engine, base, refiner):
    from sdwebui_tpu_torch.pipeline.processing import _refiner_split_idx
    from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler

    body = sdxl_request(1234, refiner.title)

    def check(params, seed):
        for want in (f"Seed: {seed}", "Sampler: DPM++ 2M", f"Refiner: {refiner.title}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    results = _serve(engine, "txt2img", [body, body], dict(body, steps=2, seed=1), check, 1024)
    _check_repeat(results, 0, 1)
    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", STEPS, base.disc, is_sdxl=True)
    s_idx = _refiner_split_idx(base, sigmas, SDXL_SWITCH_AT, STEPS)
    packed = (s_idx * launch_plan(base.unet_cfg, 128)
              + (STEPS - s_idx) * launch_plan(refiner.unet_cfg, 128))
    b5 = (s_idx * ln_plan(base.unet_cfg, 128) + (STEPS - s_idx) * ln_plan(refiner.unet_cfg, 128)
          + clip_ln_plan(base) + clip_ln_plan(refiner))
    log(f"refiner takes over after step {s_idx}")
    _check_launches(results, [_plan(b1=1, b2=packed, b5=b5)] * 2)
    return results, s_idx


def phase_sdxl_hires(engine, base, refiner):
    """6b: config 5 with hires fix; the refiner takes the second pass."""
    from sdwebui_tpu_torch.pipeline.processing import _refiner_split_idx, setup_img2img_steps
    from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler

    body = dict(sdxl_request(1234, refiner.title), enable_hr=True, hr_scale=1.5,
                hr_upscaler="Latent", denoising_strength=SDXL_HR_DENOISE,
                hr_second_pass_steps=STEPS)

    def check(params, seed):
        for want in (f"Seed: {seed}", "Hires upscale: 1.5", "Hires upscaler: Latent",
                     f"Hires steps: {STEPS}", f"Refiner: {refiner.title}",
                     f"Size: {body['width']}x{body['height']}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    warmup = dict(body, steps=2, hr_second_pass_steps=2, seed=1)
    (result,) = _serve(engine, "txt2img", [body], warmup, check, 1536)
    if result["image"].std() < 1.0:
        raise AssertionError("the SDXL hires image is flat")
    steps, t_enc = setup_img2img_steps(STEPS, SDXL_HR_DENOISE)
    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", steps, base.disc, is_sdxl=True)
    s_idx = _refiner_split_idx(base, sigmas[steps - t_enc - 1:], SDXL_SWITCH_AT, t_enc + 1)
    r_calls = t_enc + 1 - s_idx
    b2 = (STEPS * launch_plan(base.unet_cfg, 128) + s_idx * launch_plan(base.unet_cfg, 192)
          + r_calls * launch_plan(refiner.unet_cfg, 192))
    b5 = (STEPS * ln_plan(base.unet_cfg, 128) + s_idx * ln_plan(base.unet_cfg, 192)
          + r_calls * ln_plan(refiner.unet_cfg, 192) + 2 * clip_ln_plan(base)
          + clip_ln_plan(refiner))
    log(f"SDXL hires: {t_enc + 1} second-pass calls, the refiner takes over after {s_idx}")
    _check_launches([result], [_plan(b1=1, b2=b2, b5=b5)])
    return result, dict(second_pass_calls=t_enc + 1, refiner_after=s_idx)


def sdxl_img2img_request(seed: int, init_png: str) -> dict:
    """Phase 6c's SDXL img2img: 1024², DPM++ 2M Karras, 20 steps, CFG 7,
    denoising 0.75 (16 UNet calls)."""
    return dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
                seed=seed, steps=STEPS, cfg_scale=7.0, sampler_name="DPM++ 2M",
                scheduler="Karras", width=1024, height=1024, batch_size=1,
                denoising_strength=DENOISE, init_images=[init_png])


def phase_sdxl_img2img(engine, base, phase6: dict, device):
    """6c: (a) two SDXL img2img requests with one seed on a phase-6 PNG,
    (b) an SDXL inpaint with the API's defaults, (c) a random full-width
    SDXL UNet with 9 input channels on an inpaint, (d) one SDXL img2img
    request under torch.profiler.  Returns (results, info)."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sdxl
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png

    init_png = phase6["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = 1024
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1

    def plan(m, b1):
        return _plan(b1=b1, b2=calls * launch_plan(m.unet_cfg, 128),
                     b5=calls * ln_plan(m.unet_cfg, 128) + clip_ln_plan(m))

    def check(params, seed):
        for want in (f"Seed: {seed}", "Sampler: DPM++ 2M", f"Denoising strength: {DENOISE}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    body = sdxl_img2img_request(1234, init_png)
    mask, mask_png = _offcentre_mask_png(size)
    results, plans = [], []
    with _server(engine) as url:
        _post(f"{url}/img2img", dict(body, steps=2, seed=1))
        for label in ("(a) SDXL img2img", "(a) SDXL img2img repeat"):
            results.append(_request(url, "img2img", body, check, size, label))
            plans.append(plan(base, 2))
        results.append(_request(url, "img2img", dict(
            body, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpaint_full_res_padding=32),
            check, size, "(b) SDXL inpaint, API defaults"))
        plans.append(plan(base, 2))
    _check_repeat(results, 0, 1)
    _check_overlay(results[2]["image"], init, mask)
    t0 = time.perf_counter()
    nine = create_random_sdxl(seed=9, device=device, in_channels=9)
    torch.cuda.synchronize()
    log(f"random 9-channel SDXL on the card in {time.perf_counter() - t0:.2f} s")
    with _server(Engine(model=nine, device=device)) as url:
        _post(f"{url}/img2img", dict(body, steps=2, seed=1))
        results.append(_request(url, "img2img", dict(
            body, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
            inpaint_full_res=False), check, size, "(c) 9-channel SDXL inpaint"))
        plans.append(plan(nine, 3))      # B1: the init encode, the masked encode, the decode
    _check_overlay(results[-1]["image"], init, mask)
    del nine
    gc.collect()
    torch.cuda.empty_cache()
    _check_launches(results, plans)
    profile = phase_profile(engine, sdxl_img2img_request(1234, init_png), "SDXL img2img",
                            route="img2img")
    return results, dict(unet_calls=calls, seconds={r["label"]: r["seconds"] for r in results},
                         profile=profile, f32_encodes_1024=2 + 1 + 2, decodes_1024=4)


# phase 4j: the families the loader took last (SD3, SD2.1-unclip, AltDiffusion)
SD3_BASE = dict(prompt="a photograph of an astronaut riding a horse",
                negative_prompt="blurry, lowres", width=1024, height=1024,
                sampler_name="Euler", steps=STEPS, cfg_scale=5.0)
SD3_REPEAT_TOL = 1        # uint8 levels, the repeated SD3 request
SD3_TILE = 64             # the MMDiT's card-vs-CPU check: one 64² latent
SD3_HR_FIRST = 512        # the hires request's first pass (and the warm-up's size)
UNCLIP_SIZE = 768
# free space the SD3 file needs: MMDiT, VAE and the CLIPs in fp16, T5-XXL's
# matrices in fp8 (sd3_medium_incl_clips_t5xxlfp8's layout), and a margin
SD3_FILE_GB = 11.0
T5_PAD, T5_EOS, T5_UNK = 0, 1, 2


def write_spm_vocab(path: str, words, specials, ids: dict) -> None:
    """A SentencePiece ModelProto (the wire format text/sentencepiece
    parses): `specials` [(text, type)] first, then every word of `words`
    (a "▁" piece each) and the single letters, and the trainer's ids."""
    import struct

    def varint(x: int) -> bytes:
        out = b""
        while True:
            b, x = x & 0x7F, x >> 7
            if not x:
                return out + bytes([b])
            out += bytes([b | 0x80])

    def field(num, wire, payload):
        return varint((num << 3) | wire) + payload

    def ld(num, payload):
        return field(num, 2, varint(len(payload)) + payload)

    pieces = list(specials) + [("\u2581" + w, 1) for w in sorted(set(words))] \
        + [(c, 1) for c in "abcdefghijklmnopqrstuvwxyz,"] + [("\u2581", 1)]
    data = b"".join(ld(1, ld(1, t.encode()) + field(2, 5, struct.pack("<f", -float(len(t) < 3)))
                       + (field(3, 0, varint(typ)) if typ != 1 else b""))
                    for t, typ in pieces)
    trainer = b"".join(field(num, 0, varint(ids[k] % (1 << 64)))
                       for num, k in ((40, "unk"), (41, "bos"), (42, "eos"), (43, "pad")))
    with open(path, "wb") as f:
        f.write(data + ld(2, trainer))


def sd3_plan(cfg, latent: int, ctx_tokens: int) -> tuple:
    """(B2, B5) launches of one MMDiT forward at latent² with ctx_tokens
    context tokens: every joint attention with Skv >= FLASH_MIN_KV, every
    non-affine LayerNorm (models/mmdit.layer_norm_calls)."""
    from sdwebui_tpu_torch.models import mmdit
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    b2 = sum(s >= FLASH_MIN_KV for s, _, _ in mmdit.self_attention_calls(cfg, latent, ctx_tokens))
    return b2, mmdit.layer_norm_calls(cfg)


def _need_disk(directory: str, gb: float) -> None:
    free = shutil.disk_usage(directory).free / 1e9
    if free < gb:
        raise AssertionError(f"{directory} has {free:.1f} GB free; the phase writes {gb:.1f} GB "
                             f"(short by {gb - free:.1f} GB)")


def _write_ckpt(path: str, sd: dict, fp8=()) -> float:
    """Write `sd` as .safetensors: floats fp16, the keys starting with one of
    `fp8` as F8_E4M3 where 2-D; returns GB."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

    def cast(k, v):
        if not v.is_floating_point():
            return v
        if v.dim() == 2 and k.startswith(fp8):
            return v.to(torch.float8_e4m3fn)
        return v.half()

    write_safetensors(path, {k: cast(k, v) for k, v in sd.items()})
    return os.path.getsize(path) / 1e9


def _family_check(sampler: str, cfg_scale):
    def check(params, seed):
        for want in (f"Seed: {seed}", f"Sampler: {sampler}", f"CFG scale: {cfg_scale}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")
    return check


def check_mmdit(path: str, module, device) -> dict:
    """The served MMDiT (bf16, on the card) against the same file's MMDiT
    in f32 on the CPU (TF32 off), one seeded 64² latent with a 77-token
    context: max|Δ|/max|ref| <= UNET_REL_TOL, as phase 2 holds bf16 UNets."""
    from sdwebui_tpu_torch.loader import convert, load
    from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict

    sd, cfg = convert.convert_mmdit(read_state_dict(path))
    cpu = load.build("mmdit", cfg, sd, torch.device("cpu"), torch.float32)
    g = torch.Generator().manual_seed(13)
    x = torch.randn((1, 16, SD3_TILE, SD3_TILE), generator=g)
    t = torch.tensor([750.0])
    ctx = torch.randn((1, 77, cfg.context_dim), generator=g)
    y = torch.randn((1, cfg.pooled_dim), generator=g)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu(x, t, ctx, y)
        cpu_s = time.perf_counter() - t0
        got = module(x.to(device), t.to(device), ctx.to(device), y.to(device)).float().cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"SD3 MMDiT at a {SD3_TILE}² latent: card (bf16) vs CPU (f32) max|Δ|/max|ref| "
        f"{rel:.3e} (bound {UNET_REL_TOL:g}), CPU forward {cpu_s:.1f} s")
    if not rel <= UNET_REL_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"the SD3 MMDiT on the card disagrees with the CPU: {rel}")
    return dict(rel_err=rel, cpu_forward_s=cpu_s)


# 4r: tensor-parallel SD3 on meshes that name the card several times
TP_SD3_STEPS = SAMPLER_STEPS
# uint8 levels (max, mean): a bf16 model-sharded SD3 image against one
# device's; fc2's partial products are summed in fp32 and rounded once, one
# device rounds its GEMM once too, so the images differ by bf16 rounding
# carried through TP_SD3_STEPS steps of 24 blocks
TP_SD3_TOL = (24, 2.0)


@contextlib.contextmanager
def _per_shard_launches():
    """{(data rank, model rank): {"b2": n, "b5": n, "b2_shapes": set}} of
    the B2 and B5 launches made inside the block, by the shard that made
    them (parallel.collectives' thread-local axes; data rank 0 where the
    data axis is 1, model rank None outside a model shard)."""
    from sdwebui_tpu_torch.ops import attention
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod
    from sdwebui_tpu_torch.parallel import collectives

    seen, lock = {}, threading.Lock()
    real_b2, real_b5 = attention.flash_attention_packed, ln_mod.layer_norm

    def who():
        axes = collectives.axes()
        return (axes["data"][1] if "data" in axes else 0,
                axes["model"][1] if "model" in axes else None)

    def entry(k):
        return seen.setdefault(k, {"b2": 0, "b5": 0, "b2_shapes": set()})

    def b2(q, k, v, num_heads, **kw):
        with lock:
            e = entry(who())
            e["b2"] += q.is_cuda
            e["b2_shapes"].add((tuple(q.shape), num_heads))
        return real_b2(q, k, v, num_heads=num_heads, **kw)

    def b5(x, *a, **kw):
        with lock:
            entry(who())["b5"] += x.is_cuda
        return real_b5(x, *a, **kw)

    attention.flash_attention_packed, ln_mod.layer_norm = b2, b5
    try:
        yield seen
    finally:
        attention.flash_attention_packed, ln_mod.layer_norm = real_b2, real_b5


def _tp_sd3(model, card, b2_fwd: int, b5_fwd: int, clip_ln: int, info: dict) -> tuple:
    """4r: the served SD3-medium (bf16, T5 off) over model=2 (batch 1) and
    data=2 × model=2 (batch 2) at 1024², TP_SD3_STEPS steps of Euler: each
    image within TP_SD3_TOL of one device's; every model shard runs every
    joint attention at (2, 4173, 24·64) with all 24 heads and every MMDiT
    LayerNorm.  Returns (results, plans)."""
    import dataclasses

    from sdwebui_tpu_torch.parallel import mesh
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img

    steps = TP_SD3_STEPS
    cfg = model.unet_cfg
    tokens = (SD3_BASE["width"] // 8 // cfg.patch_size) ** 2 + 77
    shape = ((2, tokens, cfg.hidden), cfg.num_heads)
    results, plans = [], []

    def params(batch):
        return GenerationParams(**dict(SD3_BASE, seed=3060, batch_size=batch, steps=steps))

    def images(res):
        return list(res.images[res.index_of_first_image:])

    try:
        for data, model_axis in ((1, 2), (2, 2)):
            n = data * model_axis
            mesh.set_runtime(mesh.MeshRuntime.create(data=1, devices=[card]))
            one, one_s, one_counts = _run_counted(lambda: process_txt2img(model, params(data)))
            one_plan = _plan(b1=1, b2=steps * b2_fwd, b5=steps * b5_fwd + clip_ln)
            rt = mesh.MeshRuntime.create(data=data, model=model_axis, devices=[card] * n)
            mesh.set_runtime(rt)
            label = f"4r SD3 data={data} model={model_axis} bf16"
            rep = model.replicate(rt)
            process_txt2img(rep, dataclasses.replace(params(data), steps=1))  # shards made
            with _per_shard_launches() as per:
                out, secs, counts = _run_counted(lambda: process_txt2img(rep, params(data)))
            plan = _plan(b1=data, b2=n * steps * b2_fwd, b5=n * steps * b5_fwd + clip_ln)
            shards = {k: v for k, v in per.items() if k[1] is not None}
            want = {(d, m) for d in range(data) for m in range(model_axis)}
            per_shard = {str(k): dict(b2=v["b2"], b5=v["b5"]) for k, v in sorted(shards.items())}
            log(f"{label}: {secs:.3f} s, one device {one_s:.3f} s ({steps} steps); launches "
                f"per (data, model) shard {per_shard}")
            if set(shards) != want or any(
                    v["b2"] != steps * b2_fwd or v["b5"] != steps * b5_fwd
                    or v["b2_shapes"] != {shape} for v in shards.values()):
                raise AssertionError(f"{label}: per-shard launches {shards}, planned "
                                     f"B2 {steps * b2_fwd} at {shape} and B5 "
                                     f"{steps * b5_fwd} on each of {sorted(want)}")
            info[f"tp_sd3_{data}x{model_axis}"] = dict(
                levels=_images_within(label, images(out), images(one), TP_SD3_TOL[0],
                                      TP_SD3_TOL[1]),
                seconds=secs, one_device_seconds=one_s, per_shard=per_shard)
            results += [dict(label=label, launches=counts, seconds=secs),
                        dict(label=label + " one device", launches=one_counts, seconds=one_s)]
            plans += [plan, one_plan]
    finally:
        mesh.set_runtime(None)
    return results, plans


def phase_families(directory: str, device):
    """4j: SD3, SD2.1-unclip-h and AltDiffusion from files written from a
    seed at the published layouts, each served through --ckpt over HTTP;
    returns (results, summary).  The files are removed as each part ends."""
    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.models import mmdit
    from sdwebui_tpu_torch.pipeline.processing import setup_img2img_steps
    from sdwebui_tpu_torch.pipeline.sd_model import (create_random_alt, create_random_sd2_unclip,
                                                     create_random_sd3)
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.text import sentencepiece as spm
    from sdwebui_tpu_torch.utils.options import opts

    results, plans, info = [], [], {}
    words = " ".join([SD3_BASE["prompt"], SD3_BASE["negative_prompt"], "a cat"]).replace(",", "")
    t5_dir, xlmr_dir = os.path.join(directory, "T5"), os.path.join(directory, "XLM-R")
    os.makedirs(t5_dir)
    os.makedirs(xlmr_dir)
    write_spm_vocab(os.path.join(t5_dir, "spiece.model"), words.split(),
                    [("<pad>", 3), ("</s>", 3), ("<unk>", 2)],
                    dict(unk=T5_UNK, bos=-1, eos=T5_EOS, pad=T5_PAD))
    write_spm_vocab(os.path.join(xlmr_dir, "sentencepiece.bpe.model"), words.split(),
                    [("<unk>", 2), ("<s>", 3), ("</s>", 3)], dict(unk=0, bos=1, eos=2, pad=-1))
    load.set_tokenizer_dir("t5", t5_dir)
    load.set_tokenizer_dir("xlmr", xlmr_dir)
    try:
        # ---- (a) SD3-medium with CLIP-L, bigG and an fp8 T5-XXL ----------
        _need_disk(directory, SD3_FILE_GB)
        path = os.path.join(directory, "sd3_medium_incl_clips_t5xxlfp8.safetensors")
        t0 = time.perf_counter()
        model = create_random_sd3(seed=31, device=device, t5=True)
        model.t5_tokenizer = spm.make_t5_tokenizer(os.path.join(t5_dir, "spiece.model"))
        gb = _write_ckpt(path, load.ldm_state_dict(model), fp8=("text_encoders.t5xxl.",))
        cfg = model.unet_cfg
        del model
        gc.collect()
        torch.cuda.empty_cache()
        info["sd3_file"] = dict(gb=gb, write_s=time.perf_counter() - t0)
        log(f"wrote {os.path.basename(path)}: {gb:.2f} GB in {info['sd3_file']['write_s']:.1f} s")
        opts.set("sd3_enable_t5", False)
        engine = Engine(device=device, ckpt=path, ckpt_dirs=[directory], hash_cache=None)
        t0 = time.perf_counter()
        served = engine.sd_model
        torch.cuda.synchronize()
        info["sd3_load_s"] = time.perf_counter() - t0
        log(f"SD3 file → card (T5 off) in {info['sd3_load_s']:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        if served.kind != "sd3" or served.t5 is not None or served.unet_cfg != cfg:
            raise AssertionError(f"the SD3 file loaded as {served.kind}, {served.unet_cfg}")
        info["sd3_mmdit_check"] = check_mmdit(path, served.unet, device)
        check = _family_check("Euler", SD3_BASE["cfg_scale"])
        clip_ln = clip_ln_plan(served)
        b2_1024, b5_fwd = sd3_plan(cfg, 128, 77)
        b2_512, _ = sd3_plan(cfg, 64, 77)
        b2_1024_t5, _ = sd3_plan(cfg, 128, 154)
        _, t_enc = setup_img2img_steps(STEPS, DENOISE)
        _, t_hr = setup_img2img_steps(STEPS, HR_DENOISE)
        with _server(engine) as url:
            _post(f"{url}/txt2img", dict(SD3_BASE, seed=1, steps=2, width=SD3_HR_FIRST,
                                         height=SD3_HR_FIRST))
            body = dict(SD3_BASE, seed=3030)
            for i in range(2):
                results.append(_request(url, "txt2img", body, check, 1024,
                                        f"SD3 1024² T5 off{' repeat' if i else ''}"))
                plans.append(_plan(b1=1, b2=STEPS * b2_1024, b5=STEPS * b5_fwd + clip_ln))
            delta = int(abs(results[-1]["image"].astype(int) - results[-2]["image"].astype(int)).max())
            log(f"SD3 repeated seed: max|Δ| {delta} uint8 levels (bound {SD3_REPEAT_TOL})")
            if delta > SD3_REPEAT_TOL or results[-1]["image"].std() < 1.0:
                raise AssertionError(f"SD3 repeat differs by {delta} or is flat")
            results.append(_request(url, "img2img", dict(
                body, seed=3031, init_images=[results[0]["png_b64"]], denoising_strength=DENOISE),
                check, 1024, "SD3 img2img 1024²"))
            plans.append(_plan(b1=2, b2=(t_enc + 1) * b2_1024,
                               b5=(t_enc + 1) * b5_fwd + clip_ln))
            results.append(_request(url, "txt2img", dict(
                body, seed=3032, width=SD3_HR_FIRST, height=SD3_HR_FIRST, enable_hr=True,
                hr_scale=2.0, hr_upscaler="Latent", denoising_strength=HR_DENOISE), check,
                2 * SD3_HR_FIRST,
                "SD3 hires 512² → 1024²"))
            plans.append(_plan(b1=1, b2=STEPS * b2_512 + (t_hr + 1) * b2_1024,
                               b5=(STEPS + t_hr + 1) * b5_fwd + 2 * clip_ln))
            info["sd3_profile"] = phase_profile(
                engine, body, "SD3", wall=statistics.median(r["seconds"] for r in results[:2]))
            t0 = time.perf_counter()
            card = torch.device("cuda", torch.cuda.current_device() if device.index is None
                                else device.index)
            tp_results, tp_plans = _tp_sd3(served, card, b2_1024, b5_fwd, clip_ln, info)
            results += tp_results
            plans += tp_plans
            gc.collect()
            torch.cuda.empty_cache()
            info["tp_sd3_s"] = time.perf_counter() - t0
            log(f"4r tensor-parallel SD3: {info['tp_sd3_s']:.1f} s")
            # T5 on: the next load converts the file's fp8 T5 to bf16
            _post(f"{url}/options", {"sd3_enable_t5": True})
            _post(f"{url}/unload-checkpoint", {})
            t0 = time.perf_counter()
            served = engine.sd_model
            torch.cuda.synchronize()
            info["sd3_load_t5_s"] = time.perf_counter() - t0
            if served.t5 is None or served.t5_tokenizer is None:
                raise AssertionError("sd3_enable_t5 did not load T5 and its tokenizer")
            log(f"SD3 file → card (T5 on) in {info['sd3_load_t5_s']:.2f} s, "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
            results.append(_request(url, "txt2img", body, check, 1024, "SD3 1024² T5 on"))
            plans.append(_plan(b1=1, b2=STEPS * b2_1024_t5, b5=STEPS * b5_fwd + clip_ln))
            t5_delta = float(abs(results[-1]["image"].astype(int)
                                 - results[0]["image"].astype(int)).mean())
            log(f"SD3 T5 on vs off: mean|Δ| {t5_delta:.2f} levels")
            if not t5_delta > 1.0:
                raise AssertionError("T5's context left the SD3 image unchanged")
        opts.set("sd3_enable_t5", False)
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(path)

        # ---- (b) SD2.1-unclip-h at 768² ------------------------------------
        path = os.path.join(directory, "sd21-unclip-h.safetensors")
        t0 = time.perf_counter()
        model = create_random_sd2_unclip(seed=32, device=device)
        gb = _write_ckpt(path, load.ldm_state_dict(model))
        adm = model.unet_cfg.adm_in_channels
        del model
        torch.cuda.empty_cache()
        log(f"wrote {os.path.basename(path)}: {gb:.2f} GB in {time.perf_counter() - t0:.1f} s")
        engine = Engine(device=device, ckpt=path, ckpt_dirs=[directory], hash_cache=None)
        served = engine.sd_model
        if not served.is_unclip or served.unet_cfg.adm_in_channels != adm:
            raise AssertionError("the unclip file did not load as an unclip model")
        vit_ln = 2 + 2 * served.image_embedder.cfg.layers
        ucfg = served.unet_cfg
        unet_b2, unet_b5 = launch_plan(ucfg, 96), ln_plan(ucfg, 96)
        body = dict(SD15_BASE, seed=3040, width=UNCLIP_SIZE, height=UNCLIP_SIZE)
        with _server(engine) as url:
            results.append(_request(url, "txt2img", body, _sd15_check, UNCLIP_SIZE,
                                    "unclip 768² txt2img (zero adm)"))
            plans.append(_plan(b1=1, b2=STEPS * unet_b2,
                               b5=STEPS * unet_b5 + clip_ln_plan(served)))
            results.append(_request(url, "img2img", dict(
                body, seed=3041, init_images=[results[-1]["png_b64"]],
                denoising_strength=DENOISE), _sd15_check, UNCLIP_SIZE, "unclip 768² img2img"))
            plans.append(_plan(b1=2, b2=(t_enc + 1) * unet_b2,
                               b5=(t_enc + 1) * unet_b5 + clip_ln_plan(served) + vit_ln))
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(path)

        # ---- (c) AltDiffusion at 512² --------------------------------------
        path = os.path.join(directory, "AltDiffusion.safetensors")
        t0 = time.perf_counter()
        model = create_random_alt(seed=33, device=device)
        gb = _write_ckpt(path, load.ldm_state_dict(model))
        xlayers = model.conditioner.cfg.layers
        del model
        torch.cuda.empty_cache()
        log(f"wrote {os.path.basename(path)}: {gb:.2f} GB in {time.perf_counter() - t0:.1f} s")
        engine = Engine(device=device, ckpt=path, ckpt_dirs=[directory], hash_cache=None)
        served = engine.sd_model
        if served.kind != "alt" or served.conditioner.tokenizer is None:
            raise AssertionError("the AltDiffusion file loaded without its XLM-R tokenizer")
        acfg = served.unet_cfg
        with _server(engine) as url:
            results.append(_request(url, "txt2img", dict(SD15_BASE, seed=3050), _sd15_check, 512,
                                    "AltDiffusion 512²"))
            plans.append(_plan(b1=1, b2=STEPS * launch_plan(acfg, 64),
                               b5=STEPS * ln_plan(acfg, 64) + 1 + 2 * xlayers))
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(path)
    finally:
        load.set_tokenizer_dir("t5", None)
        load.set_tokenizer_dir("xlmr", None)
        opts.set("sd3_enable_t5", False)
    _check_launches(results, plans)
    info["seconds"] = {r["label"]: r["seconds"] for r in results}
    # B1 calls by phase-1 row: the SD3 VAE's mid block at 128² (the 1024²
    # decodes, bf16, 4r's five among them; the img2img encode, f32) and
    # unclip's at 96²
    info["b1_calls"] = {("vae_mid_1024", "bfloat16"): 5 + 5, ("vae_mid_1024_f32", "float32"): 1,
                        ("vae_mid_768", "bfloat16"): 2, ("vae_mid_768_f32", "float32"): 1,
                        ("vae_mid_512", "bfloat16"): 1}
    return results, info


# --------------------------------------------------------------------------
# 4k: the UNet and sampling options, fp8 storage, the card's noise stream,
# PNG embedding cards and a pruned SDXL file
# --------------------------------------------------------------------------

OPT_PROMPT = "a photograph of an (astronaut:1.2) riding a ((horse)), [blurry]"
OPT_SEED = 4242
NOISE_ULP_TOL = 2         # the card's device Philox vs the same code on the CPU, f32 ulps
# the requests of 4k(a), SD1.5 512² batch 1, 20 steps, each with the cond
# cache on: (label, override_settings, a cond-cache hit).  A request whose
# options replace the model bundle (hypertile, ToMe, upcast_attn, the
# schedule override) encodes anew: the cache keys on the bundle; the
# "GPU" noise source and the repeat reuse the plain request's conds.
OPTION_REQUESTS = [
    ("plain", {}, False),
    ("hypertile", {"hypertile_enable_unet": True}, False),
    ("tome_0.5", {"token_merging_ratio": 0.5}, False),
    ("upcast_attn", {"upcast_attn": True}, False),
    ("ztsnr_sgm", {"sd_noise_schedule": "Zero Terminal SNR", "sgm_noise_multiplier": True},
     False),
    ("old_emphasis", {"use_old_emphasis_implementation": True}, False),
    ("gpu_noise", {"randn_source": "GPU"}, True),      # the NV floats, drawn on the card
    ("plain_repeat", {}, True),
]


def options_plan(model, label: str, overrides: dict, cached: bool, latent: int = 64) -> dict:
    """B1, B2 and B5 launches of one 4k(a) request, written before the run
    from the config, the request's attention options and the dispatch rule:
    B2 for every self-attention whose KV reaches FLASH_MIN_KV after ToMe's
    merge or hypertile's split (SD1.5 512², 20 steps: plain 200; hypertile
    200 = 100 at (8, 1024, 8·40) + 100 at (2, 1024, 8·80); ToMe 0.5 100 at
    (2, 2048, 8·40), its 32² level merged to 512 tokens on the plain path;
    upcast_attn 200 in f32), B5 three a transformer block a step plus
    CLIP's 26 unless the conds come from the cache (986, a hit 960), B1
    the decode."""
    from sdwebui_tpu_torch.models.unet import AttentionOptions, self_attention_shapes
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    tile = 0
    if overrides.get("hypertile_enable_unet"):
        tile = max(int(overrides.get("hypertile_max_tile_unet", 256)) // 8, 16)
    attn = AttentionOptions(tile, float(overrides.get("token_merging_ratio", 0.0)),
                            bool(overrides.get("upcast_attn", False)))
    shapes = self_attention_shapes(model.unet_cfg, latent, 2, attn)
    b2 = STEPS * sum(s >= FLASH_MIN_KV for _, s, _, _ in shapes)
    b5 = STEPS * ln_plan(model.unet_cfg, latent) + (0 if cached else clip_ln_plan(model))
    return _plan(b1=1, b2=b2, b5=b5)


def noise_stream(device) -> dict:
    """4k(c): the device Philox source (randn_source "GPU") on the card
    against the same code on the CPU and against the host "NV" Philox (in
    f32 ulps of the larger magnitude, <= NOISE_ULP_TOL each), and against
    torch.randn with a CUDA generator seeded alike (reported only): 21
    draws of 4×64×64 for two seeds, a txt2img run's first noise and its
    ancestral steps."""
    from sdwebui_tpu_torch.rng.device_philox import DevicePhiloxRNG
    from sdwebui_tpu_torch.rng.image_rng import ImageRNG

    seeds, shape = [OPT_SEED, 7], (4, 64, 64)

    def draws(dev):
        rng = DevicePhiloxRNG(shape, seeds, dev)
        return torch.cat([rng.first()[None], rng.next_k(STEPS)]).cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = draws(device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = draws("cpu")
    host_rng = ImageRNG(shape, seeds, channels_last=False)
    host = torch.cat([torch.from_numpy(host_rng.first())[None],
                      torch.from_numpy(host_rng.next_k(STEPS))])
    scale = torch.maximum(card.abs(), cpu.abs())
    ulps = ((card - cpu).abs() / torch_spacing(scale)).max().item()
    g = torch.Generator(device=device).manual_seed(OPT_SEED)
    randn = torch.randn(shape, generator=g, device=device).cpu()
    out = dict(card_s=card_s, max_ulps_card_vs_cpu=ulps,
               max_abs_card_vs_cpu=(card - cpu).abs().max().item(),
               max_abs_card_vs_host_nv=(card - host).abs().max().item(),
               max_abs_card_vs_torch_randn=(card[0, 0] - randn).abs().max().item())
    log(f"4k(c) noise stream: {out}")
    if not torch.isfinite(card).all() or ulps > NOISE_ULP_TOL:
        raise AssertionError(f"the card's noise stream is {ulps} ulps from the CPU's "
                             f"(bound {NOISE_ULP_TOL})")
    out["max_ulps_card_vs_host_nv"] = ((card - host).abs() / torch_spacing(
        torch.maximum(card.abs(), host.abs()))).max().item()
    if out["max_ulps_card_vs_host_nv"] > NOISE_ULP_TOL:
        raise AssertionError(f"the card's noise stream is {out['max_ulps_card_vs_host_nv']} "
                             "ulps from the host NV stream")
    return out


def torch_spacing(x):
    """float32 ulp of each magnitude."""
    return torch.nextafter(x.float(), torch.full_like(x.float(), float("inf"))) - x.float()


def write_embedding_card(directory: str, model, name: str = "chipcard", seed: int = 13) -> str:
    """A PNG embedding card at the model's CLIP width with its embedding in
    the ``sd-ti-embedding`` text chunk (the reference's base64 JSON,
    tensors as {"TORCHTENSOR": nested lists}), written with the port's PNG
    encoder over a seeded preview."""
    from sdwebui_tpu_torch.utils.png import encode_png

    g = torch.Generator().manual_seed(seed)
    vec = torch.randn((2, model.conditioner.cfg.width), generator=g) * 0.02
    data = {"string_to_param": {"*": {"TORCHTENSOR": vec.tolist()}}, "name": name,
            "step": 500}
    text = base64.b64encode(json.dumps(data).encode()).decode()
    preview = torch.randint(0, 256, (64, 64, 3), generator=g, dtype=torch.uint8).numpy()
    path = os.path.join(directory, f"{name}.png")
    with open(path, "wb") as f:
        f.write(encode_png(preview, {"sd-ti-embedding": text}))
    return path


def _level_diff(a, b) -> dict:
    d = abs(a.astype(int) - b.astype(int))
    return dict(mean_levels=float(d.mean()), max_levels=int(d.max()))


def phase_options(engine, model, directory: str, device):
    """4k(a), (c), (d), (e) on the SD1.5 server; returns (results, info)."""
    from sdwebui_tpu_torch.networks.textual_inversion import DEFAULT_EMBEDDINGS_DIR

    def check(params, seed):
        _sd15_check(params, seed)

    info, results = {}, []
    base = dict(SD15_BASE, prompt=OPT_PROMPT, seed=OPT_SEED, batch_size=1)
    with _server(engine) as url:
        _post(f"{url}/txt2img", dict(base, steps=2, seed=1, override_settings={
            "hypertile_enable_unet": True, "token_merging_ratio": 0.5}))
        for label, overrides, _ in OPTION_REQUESTS:
            body = dict(base, override_settings=dict(overrides, persistent_cond_cache=True))
            results.append(_request(url, "txt2img", body, check, 512, label=f"4k {label}"))
        plain = results[0]["image"]
        info["options"] = {}
        for (label, overrides, cached), r in zip(OPTION_REQUESTS, results):
            info["options"][label] = dict(seconds=r["seconds"], launches=r["launches"],
                                          plan=options_plan(model, label, overrides, cached),
                                          **_level_diff(r["image"], plain))
        log(f"4k(a) options against the plain image: "
            f"{ {k: (v['mean_levels'], v['seconds']) for k, v in info['options'].items()} }")
        _check_launches(results, [options_plan(model, *r) for r in OPTION_REQUESTS])
        if info["options"]["plain_repeat"]["max_levels"] != 0:
            raise AssertionError("the repeated plain request differs from the first")
        for label in ("hypertile", "tome_0.5", "ztsnr_sgm", "old_emphasis"):
            if info["options"][label]["max_levels"] == 0:
                raise AssertionError(f"option {label} left the image as it was")
        # the device source draws the host NV floats: the plain image again
        if info["options"]["gpu_noise"]["max_levels"] > REPEAT_TOL:
            raise AssertionError("the 'GPU' noise source's image differs from the NV one's")
        for want, label in (("Token merging ratio: 0.5", "tome_0.5"),
                            ("Noise Schedule: Zero Terminal SNR", "ztsnr_sgm"),
                            ("SGM noise multiplier: True", "ztsnr_sgm")):
            if want not in results[[r[0] for r in OPTION_REQUESTS].index(label)]["infotext"]:
                raise AssertionError(f"{label}'s infotext lacks {want!r}")
        info["noise"] = noise_stream(device)
        pose_result, info["openpose"] = openpose_part(engine, model, directory, device, url,
                                                      results[0]["png_b64"])
        results.append(pose_result)
        # (e) a PNG embedding card in the prompt
        write_embedding_card(directory, model)
        engine.embeddings_dir = directory
        engine.refresh_embeddings()
        try:
            body = dict(base, prompt=OPT_PROMPT + ", chipcard", seed=OPT_SEED)
            card = _request(url, "txt2img", body, check, 512, label="4k(e) embedding card")
        finally:
            engine.embeddings_dir = DEFAULT_EMBEDDINGS_DIR
            engine.refresh_embeddings()
        if 'TI hashes: "chipcard: ' not in card["infotext"]:
            raise AssertionError(f"the card's embedding is not in the infotext: "
                                 f"{card['infotext']!r}")
        _check_launches([card], [_plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                                       b5=STEPS * ln_plan(model.unet_cfg, 64)
                                       + clip_ln_plan(model))])
        info["embedding_card"] = dict(seconds=card["seconds"], **_level_diff(card["image"], plain))
        results.append(card)
    # where ToMe's time goes (it runs slower than the plain request)
    tome = next(o for name, o, _ in OPTION_REQUESTS if name == "tome_0.5")
    info["profile_tome"] = phase_profile(
        engine, dict(base, override_settings=dict(tome, persistent_cond_cache=True)), "4k ToMe")
    return results, info


OPENPOSE_REL_TOL = 1e-4    # max|Δ| / max|ref|, the body net on the card vs the CPU, f32
OPENPOSE_SEED = 17


def openpose_part(engine, model, directory: str, device, url: str, png_b64: str) -> tuple:
    """4k(d): a body_pose_model.safetensors and a ControlNet tower written
    from seeds at the published widths; the body net on the card against
    the CPU (f32, TF32 off) at a 96² input, its ms a forward at 512²; /controlnet/detect openpose on a 512² PNG; a 512² request with
    an openpose unit (B2 = 20 × (10 + 4), B5 = 20 × (48 + 21) + 26)."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.openpose import (body_pose_state_dict,
                                                   create_random_openpose,
                                                   openpose_from_state_dict)
    from sdwebui_tpu_torch.pipeline import annotators, control
    from sdwebui_tpu_torch.utils.png import decode_png

    from sdwebui_tpu_torch.models.openpose import pose_maps

    net = create_random_openpose(OPENPOSE_SEED, device)
    sd = {k: v.cpu() for k, v in body_pose_state_dict(net).items()}
    # the random net's maps are flat (~1e-5): its last convs are scaled on
    # the phase's image so that heatmaps hold peaks (0.05 ± 0.15) and PAFs
    # vary (0 ± 0.15), and the hint draws people
    image = decode_png(base64.b64decode(png_b64))[0]
    heat, paf = pose_maps(net, image)
    for branch, maps, offset in ((2, heat, 0.05), (1, paf, 0.0)):
        gain = 0.15 / maps.std()
        w, b = f"Mconv7_stage6_L{branch}.weight", f"Mconv7_stage6_L{branch}.bias"
        sd[w], sd[b] = sd[w] * gain, sd[b] * gain - maps.mean() * gain + offset
    write_safetensors(os.path.join(directory, "body_pose_model.safetensors"), sd)
    net = openpose_from_state_dict(sd, device)
    cpu_net = openpose_from_state_dict(sd, "cpu")
    g = torch.Generator().manual_seed(OPENPOSE_SEED)
    x = torch.rand((1, 3, 96, 96), generator=g) - 0.5
    with torch.inference_mode():
        ref = cpu_net(x)
        out = [t.cpu() for t in net(x.to(device))]
        agree = [agreement(o, r, torch.float32, rel_tol=OPENPOSE_REL_TOL)
                 for o, r in zip(out, ref)]
        x512 = (torch.rand((1, 3, 512, 512), generator=g) - 0.5).to(device)
        forward_ms = cuda_ms(lambda: net(x512), iters=3, warmup=1)
    log(f"4k(d) body net card vs CPU: paf {agree[0]['text']}, heatmap {agree[1]['text']}; "
        f"{forward_ms:.2f} ms a forward at 512²")
    if not all(a["ok"] for a in agree):
        raise AssertionError("the openpose body net on the card disagrees with the CPU's")
    del net, cpu_net
    tower = random_tower(model.unet_cfg, 11, device)
    write_safetensors(os.path.join(directory, "chipcn.safetensors"),
                      {"control_model." + k: v.half() for k, v in tower.state_dict().items()})
    del tower
    torch.cuda.empty_cache()
    prev = list(annotators._model_dirs)
    annotators.set_annotator_dirs([directory])
    control.set_model_dirs([directory])
    try:
        t0 = time.perf_counter()
        detect = _post(url.replace("/sdapi/v1", "/controlnet/detect"), {
            "controlnet_module": "openpose", "controlnet_input_images": [png_b64],
            "controlnet_processor_res": 512})
        detect_s = time.perf_counter() - t0
        hint = decode_png(base64.b64decode(detect["images"][0]))[0]
        if hint.shape[:2] != (512, 512):
            raise AssertionError(f"the openpose hint is {hint.shape}")
        body = dict(SD15_BASE, seed=OPT_SEED, batch_size=1, controlnet_units=[
            dict(model="chipcn", module="openpose", image=png_b64, weight=1.0)])
        r = _request(url, "txt2img", body, _sd15_check, 512, label="4k(d) openpose unit")
    finally:
        annotators.set_annotator_dirs(prev)
        control.set_model_dirs([control.DEFAULT_CONTROLNET_DIR])
    cfg = model.unet_cfg
    plan = _plan(b1=1, b2=STEPS * (launch_plan(cfg, 64) + launch_plan(cfg, 64, False)),
                 b5=STEPS * (ln_plan(cfg, 64) + ln_plan(cfg, 64, False)) + clip_ln_plan(model))
    _check_launches([r], [plan])
    info = dict(forward_ms_512=forward_ms, paf_rel_err=agree[0]["rel_err"],
                heatmap_rel_err=agree[1]["rel_err"], detect_s=detect_s,
                hint_nonzero_share=float((hint > 0).any(axis=-1).mean()),
                unit_request_s=r["seconds"])
    log(f"4k(d) openpose: {info}")
    return r, info


def _unet_state(unet) -> dict:
    return {k: v.detach().clone() for k, v in unet.state_dict().items()}


def phase_options_sdxl(engine, base, directory: str, device):
    """4k(b): fp8 storage "Enable for SDXL" with cache_fp16_weight on the
    SDXL server (the UNet's resident bytes in fp8 and bf16, s/request, the
    image's level difference, the switch back bit for bit); 4k(f): an
    SSD-1B-pruned SDXL file served once at 1024².  Returns (results, info)."""
    from sdwebui_tpu_torch.loader.load import ssd1b_state_dict
    from sdwebui_tpu_torch.models.unet import state_dict_depths
    from sdwebui_tpu_torch.pipeline.sd_model import has_fp8
    from sdwebui_tpu_torch.server.app import Engine

    body = dict(prompt=OPT_PROMPT, negative_prompt="blurry", seed=OPT_SEED, steps=STEPS,
                cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="Karras", width=1024,
                height=1024, batch_size=1)

    def check(params, seed):
        if f"Seed: {seed}" not in params:
            raise AssertionError(f"infotext lacks the seed: {params!r}")

    plan = _plan(b1=1, b2=STEPS * launch_plan(base.unet_cfg, 128),
                 b5=STEPS * ln_plan(base.unet_cfg, 128) + clip_ln_plan(base))
    before = _unet_state(base.unet)
    info = {}
    with _server(engine) as url:
        plain = _request(url, "txt2img", body, check, 1024, label="4k(b) bf16")
        torch.cuda.synchronize()
        bf16_bytes = torch.cuda.memory_allocated()
        on = {"fp8_storage": "Enable for SDXL", "cache_fp16_weight": True}
        fp8 = _request(url, "txt2img", dict(body, override_settings=on), check, 1024,
                       label="4k(b) fp8")
        torch.cuda.synchronize()
        fp8_bytes = torch.cuda.memory_allocated()
        if not has_fp8(base):
            raise AssertionError("fp8_storage 'Enable for SDXL' left the SDXL UNet in bf16")
        fp8_unet = sum(p.numel() * p.element_size() for p in base.unet.parameters())
        back = _request(url, "txt2img", dict(body, override_settings={"fp8_storage": "Disable"}),
                        check, 1024, label="4k(b) back to bf16")
    after = _unet_state(base.unet)
    if has_fp8(base) or any(not torch.equal(after[k], v) for k, v in before.items()):
        raise AssertionError("the switch back from fp8 did not restore the bf16 weights bit "
                             "for bit")
    del before, after
    bf16_unet = sum(p.numel() * p.element_size() for p in base.unet.parameters())
    _check_launches([plain, fp8, back], [plan] * 3)
    info["fp8"] = dict(unet_bytes_bf16=bf16_unet, unet_bytes_fp8=fp8_unet,
                       allocated_bf16=bf16_bytes, allocated_fp8=fp8_bytes,
                       seconds_bf16=plain["seconds"], seconds_fp8=fp8["seconds"],
                       back_levels=_level_diff(back["image"], plain["image"]),
                       **_level_diff(fp8["image"], plain["image"]))
    log(f"4k(b) fp8 storage: {info['fp8']}")
    if info["fp8"]["back_levels"]["max_levels"] > REPEAT_TOL:
        raise AssertionError("the request after the switch back differs from the bf16 one")
    # (f) the pruned file
    t0 = time.perf_counter()
    sd = ssd1b_state_dict(base)
    path = os.path.join(directory, "ssd1b-random.safetensors")
    _need_disk(directory, 6.0)
    gb = _write_ckpt(path, sd)
    depths = state_dict_depths(k[len("model.diffusion_model."):] for k in sd
                               if k.startswith("model.diffusion_model."))
    del sd
    write_s = time.perf_counter() - t0
    pruned_engine = Engine(ckpt=path, device=device, hash_cache=None)
    try:
        pruned = pruned_engine.sd_model
        if any(p.is_meta for p in pruned.unet.parameters()) or len(pruned.unet.middle_block) != 1:
            raise AssertionError("the pruned file did not build its own depths")
        from sdwebui_tpu_torch.models.unet import self_attention_calls
        from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

        calls = self_attention_calls(pruned.unet_cfg, 128, depths=depths)
        pruned_plan = _plan(b1=1, b2=STEPS * sum(s >= FLASH_MIN_KV for s, _, _ in calls),
                            b5=STEPS * 3 * len(calls) + clip_ln_plan(pruned))
        with _server(pruned_engine) as url:
            r = _request(url, "txt2img", body, check, 1024, label="4k(f) pruned SDXL")
        _check_launches([r], [pruned_plan])
        if r["image"].std() < 1.0:
            raise AssertionError("the pruned SDXL image is flat")
    finally:
        del pruned_engine
        os.remove(path)
        gc.collect()
        torch.cuda.empty_cache()
    info["pruned"] = dict(file_gb=gb, write_s=write_s, seconds=r["seconds"],
                          transformer_blocks=len(calls), launches=r["launches"])
    log(f"4k(f) pruned SDXL: {info['pruned']}")
    return [plain, fp8, back, r], info


def kernel_class(name: str) -> str:
    if "flash_attention" in name or "attn_" in name:   # csrc/flash_attention.cu
        return "flash_attn"
    if "layer_norm_kernel" in name or "layer_norm_reg_kernel" in name:   # csrc/layer_norm.cu
        return "layer_norm"
    if "fprop" in name or "conv" in name.lower():
        return "conv"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "gemm"
    if "reduce_kernel" in name:
        return "reduce"
    if "elementwise" in name or "copy" in name.lower():
        return "elementwise"
    return "other"


def kernel_times(fn, top: int = 8) -> dict:
    """Device ms of one call of fn under torch.profiler: the sum by kernel
    class and the `top` kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start:
            by_name[e.name] = by_name.get(e.name, 0) + (e.time_range.end - e.time_range.start) / 1e3
    by_class = {}
    for name, t in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0) + t
    return dict(by_class=by_class, total_ms=sum(by_name.values()),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def phase_profile(engine, body: dict, label: str, wall: float | None = None,
                  route: str = "txt2img"):
    """One in-process request (the server's request parser and
    Engine.txt2img or .img2img, without HTTP) under torch.profiler (CUDA activity):
    device busy is the union of the kernel intervals; the wall is `wall`
    where given (config 3: the median of phase 4c's two timed requests over
    HTTP), else the median of two in-process requests without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sdwebui_tpu_torch.server.api import _params_from_request

    def run():
        p = _params_from_request(body, img2img=route == "img2img")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (engine.img2img if route == "img2img" else engine.txt2img)(p)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    if wall is None:
        wall = statistics.median([run(), run()])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.time_range.end <= e.time_range.start:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0) + dur
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_s = busy / 1e6
    by_class = {}
    for name, t in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0) + t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    summary = dict(wall_s=wall, traced_wall_s=traced, device_busy_s=busy_s,
                   idle_share=1 - busy_s / wall, device_events=len(spans),
                   device_ms_by_class=by_class,
                   top_kernels_ms=[(n[:100], t / 1e3) for n, t in top],
                   device=torch.cuda.get_device_name(0))
    log(f"{label} request profile: wall {wall:.3f} s (traced {traced:.3f} s), device busy "
        f"{busy_s:.3f} s, idle share {1 - busy_s / wall:.3f}, {len(spans)} device events; "
        "device ms by class " + json.dumps({k: round(v, 1) for k, v in by_class.items()}))
    return summary


SCRIPT_STEPS = (10, 20)   # phase 4m: the X/Y/Z Steps axis
SCRIPT_CFGS = (5.0, 7.5)  # and its CFG Scale axis
ALT_STEPS = 10            # img2img alternative's decode steps
NOISE_REPEAT_TOL = 1e-3   # max|Δ| of two inversions of one image (unit-std noise)
UPSCALE_DENOISE = 0.4     # SD upscale: 9 UNet calls a batch of tiles


def _launch_plan_hw(cfg, h: int, w: int) -> int:
    """B2 launches of one UNet forward at an h x w latent: the square plan's
    levels, each at h·w tokens scaled down as the square's are."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    return sum(s * w >= FLASH_MIN_KV * h for s, _, _ in self_attention_calls(cfg, h))


def _hook_plan(batch: int, mask: bool = False, hires: bool = False) -> list:
    """The hooks one generation fires on an always-on script, in order."""
    plan = ["setup", "before_process", "after_extra_networks_activate", "process",
            "before_process_batch", "process_batch", "process_before_every_sampling"]
    if hires:
        plan.append("process_before_every_sampling")
    if mask:
        plan.append("on_mask_blend")
    plan += ["post_sample", "postprocess_batch", "postprocess_batch_list"]
    plan += ["postprocess_image"] * batch
    if mask:
        plan += ["postprocess_maskoverlay"] * batch
    return plan + ["postprocess"]


def _img2img_hook_plan(batch: int, mask: bool = False) -> list:
    plan = _hook_plan(batch, mask)
    return plan[:-1] + ["postprocess_image_after_composite"] * batch + ["postprocess"]


class _HookRecorder:
    """An always-on script recording each hook it sees, and a log handler
    catching every hook or callback error the runner logs and swallows."""

    def __init__(self):
        import logging

        from sdwebui_tpu_torch.scripts import framework

        self.seen, self.errors = [], []
        seen = self.seen

        class Recorder(framework.Script):
            name = "chip-recorder"
            alwayson = True

        for hook in ("setup", "before_process", "process", "before_process_batch",
                     "after_extra_networks_activate", "process_before_every_sampling",
                     "process_batch", "on_mask_blend", "post_sample", "postprocess_batch",
                     "postprocess_batch_list", "postprocess_maskoverlay",
                     "postprocess_image_after_composite", "postprocess"):
            setattr(Recorder, hook, lambda self, p, *a, _h=hook, **kw: seen.append(_h))

        def postprocess_image(self, p, image, *a):
            seen.append("postprocess_image")
            return image

        Recorder.postprocess_image = postprocess_image
        self.script = Recorder()
        errors = self.errors

        class Catch(logging.Handler):
            def emit(self, record):
                errors.append(self.format(record))

        self.handler = Catch(logging.ERROR)
        self.logger = logging.getLogger("sdwebui_tpu_torch.scripts.framework")

    def __enter__(self):
        from sdwebui_tpu_torch.scripts import framework

        framework.get_runner().add(self.script)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        from sdwebui_tpu_torch.scripts import framework

        framework.get_runner().alwayson_scripts.remove(self.script)
        self.logger.removeHandler(self.handler)

    def check(self, label: str, plan: list):
        """The hooks since the last check equal `plan`, and no hook failed."""
        seen, self.seen[:] = list(self.seen), []
        if self.errors:
            raise AssertionError(f"{label}: a script hook failed: {self.errors[0][-2000:]}")
        if seen != plan:
            raise AssertionError(f"{label}: hooks {seen} != planned {plan}")


def _post_status(url, body=None):
    """(HTTP status, decoded JSON answer) of a POST (GET without a body)."""
    import urllib.error

    try:
        return 200, _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _script_request(url, route, body, label, planned, hooks, recorder, size=None) -> dict:
    """POST one script request: its images decoded (the grid first where the
    script makes one), seconds and launches, each checked against the plan;
    the recorder's hooks against `hooks`."""
    from sdwebui_tpu_torch.utils.png import decode_png

    reset_counts()
    t0 = time.perf_counter()
    res = _post(f"{url}/{route}", body)
    dt = time.perf_counter() - t0
    launches = read_counts()
    images = [decode_png(base64.b64decode(b)) for b in res["images"]]
    for img, _ in images:
        if str(img.dtype) != "uint8" or not img.std() > 1.0:
            raise AssertionError(f"{label}: a flat or non-uint8 image")
    if size is not None and images[-1][0].shape[:2] != size:
        raise AssertionError(f"{label}: image {images[-1][0].shape}, expected {size}")
    log(f"4m {label}: {dt:.3f} s, {len(images)} images, launches {launches}")
    if launches != planned:
        raise AssertionError(f"{label}: launches {launches} != planned {planned}")
    recorder.check(label, hooks)
    return dict(route=route, label=f"4m {label}", batch=len(images), seed=body.get("seed"),
                seconds=dt, images_per_s=len(images) / dt, launches=launches,
                images=[img for img, _ in images],
                infotexts=[text.get("parameters", "") for _, text in images])


def phase_scripts(engine, model, phase3: dict, device):
    """4m: the scripts on the phase-3 server.  Returns (results, info)."""
    import copy
    import dataclasses

    from sdwebui_tpu_torch.pipeline import processing
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.sd_unet import SdUnetOption
    from sdwebui_tpu_torch.sampling.schedulers import get_schedule
    from sdwebui_tpu_torch.scripts import framework
    from sdwebui_tpu_torch.server.app import Engine

    cfg = model.unet_cfg
    size = SD15_BASE["width"]              # 512: every count below is at this size
    lat, edge = size // 8, size // 8       # the latent; outpainting's and the tiles' overlap
    lp, ln, clip = launch_plan(cfg, lat), ln_plan(cfg, lat), clip_ln_plan(model)

    def plan(calls: int, encodes: int, b1: int, b2_per_call: int = lp) -> dict:
        return _plan(b1=b1, b2=calls * b2_per_call, b5=calls * ln + encodes * clip)

    base = dict(SD15_BASE, seed=1234, batch_size=1)
    i2i = dict(base, init_images=[phase3["png_b64"]], denoising_strength=DENOISE)
    results, info = [], {}
    t_phase = time.perf_counter()
    with _server(engine) as url, _HookRecorder() as rec:
        # (a) the two listing routes
        with urllib.request.urlopen(f"{url}/scripts", timeout=60) as r:
            names = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/script-info", timeout=60) as r:
            script_info = json.loads(r.read())
        want = {"x/y/z plot", "prompts from file or textbox", "loopback", "sd upscale",
                "outpainting mk2", "poor man's outpainting", "img2img alternative test",
                "prompt matrix"}
        if not want <= set(names["txt2img"]) or "custom code" in names["txt2img"] \
                or names["img2img"] != names["txt2img"]:
            raise AssertionError(f"4m /scripts: {names}")
        if {s["name"] for s in script_info} != set(names["txt2img"]) | {
                "custom code", "postprocessing (main ui)"} or not all(
                isinstance(s["args"], list) for s in script_info):
            raise AssertionError(f"4m /script-info: {[s['name'] for s in script_info]}")
        # (b) X/Y/Z: Steps x CFG Scale, each cell the plain request's image
        xyz = ["Steps", ", ".join(map(str, SCRIPT_STEPS)),
               "CFG Scale", ", ".join(map(str, SCRIPT_CFGS)), "Nothing", "", False]
        cells = [(s, c) for c in SCRIPT_CFGS for s in SCRIPT_STEPS]
        res = _script_request(url, "txt2img", dict(base, script_name="X/Y/Z plot",
                                                   script_args=xyz), "X/Y/Z",
                              plan(sum(s for s, _ in cells), len(cells), len(cells)),
                              _hook_plan(1) * len(cells), rec)
        if [im.shape for im in res["images"]] != [(2 * size, 2 * size, 3)] \
                + [(size, size, 3)] * 4:
            raise AssertionError(f"4m X/Y/Z shapes {[im.shape for im in res['images']]}")
        results.append(res)
        for (steps, scale), cell, text in zip(cells, res["images"][1:], res["infotexts"][1:]):
            plain = _script_request(url, "txt2img", dict(base, steps=steps, cfg_scale=scale),
                                    f"plain {steps} steps CFG {scale}",
                                    plan(steps, 1, 1), _hook_plan(1), rec)
            delta = int(abs(plain["images"][0].astype(int) - cell.astype(int)).max())
            if delta > REPEAT_TOL or plain["infotexts"][0] != text:
                raise AssertionError(f"4m X/Y/Z cell {steps}/{scale}: max|Δ| {delta} from the "
                                     f"plain request, infotexts {text!r} {plain['infotexts']!r}")
            results.append(plain)
        # the legend's one refusal (4s draws the legend): Pillow's default font
        # at a size other than 10, which JAX falls back to when the font
        # option names a file that cannot be opened; one 1-step cell
        _post(f"{url}/options", {"font": "/no/such/font.ttf"})
        try:
            status, err = _post_status(f"{url}/txt2img", dict(
                base, steps=1, script_name="X/Y/Z plot",
                script_args=["Nothing", "", "Nothing", "", "Nothing", "", True]))
        finally:
            _post(f"{url}/options", {"font": ""})
        if status != 422 or "TrueType font" not in err["detail"]:
            raise AssertionError(f"4m X/Y/Z legend in a missing font: {status} {err}")
        rec.check("X/Y/Z legend", _hook_plan(1))
        # (c) prompts from file, the seed iterated
        lines = "a photograph of an astronaut riding a horse\na red bicycle in the snow"
        res = _script_request(url, "txt2img", dict(
            base, script_name="Prompts from file or textbox", script_args=[True, False, lines]),
            "prompts from file", plan(2 * STEPS, 2, 2), _hook_plan(1) * 2, rec)
        if "Seed: 1235," not in res["infotexts"][1]:
            raise AssertionError(f"4m prompts from file: {res['infotexts']}")
        results.append(res)
        # (d) loopback, 2 loops: strengths 0.625 and 0.5
        calls = [int(d * STEPS) + 1 for d in (DENOISE + (0.5 - DENOISE) * 0.5, 0.5)]
        results.append(_script_request(
            url, "img2img", dict(i2i, script_name="Loopback", script_args=[2, 0.5, "Linear"]),
            "loopback", plan(sum(calls), 2, 4), _img2img_hook_plan(1) * 2, rec))
        # (e) SD upscale x2, Lanczos, batch 4: 9 tiles of 512² at overlap 64 in
        # batches of 4, 4 and 1, each an encode and a decode
        calls = int(UPSCALE_DENOISE * STEPS) + 1
        res = _script_request(url, "img2img", dict(
            i2i, batch_size=4, denoising_strength=UPSCALE_DENOISE, script_name="SD upscale",
            script_args=[edge, "Lanczos", 2.0]), "SD upscale", plan(3 * calls, 3, 6),
            _img2img_hook_plan(4) * 2 + _img2img_hook_plan(1), rec, size=(2 * size, 2 * size))
        results.append(res)
        # (f) outpainting mk2, 64 px left and right: a 640 x 512 inpaint
        calls = int(DENOISE * STEPS) + 1
        results.append(_script_request(url, "img2img", dict(
            i2i, script_name="Outpainting mk2",
            script_args=[edge, 8, "left, right", 1.0, 0.05]), "outpainting mk2",
            plan(calls, 1, 2, _launch_plan_hw(cfg, lat, lat + 2 * edge // 8)),
            _img2img_hook_plan(1, mask=True), rec, size=(size, size + 2 * edge)))
        # (g) img2img alternative: the inverted noise alone (finite, unit std,
        # repeatable), then the script: 10 inversion calls and 10 decode calls
        from sdwebui_tpu_torch.utils.png import decode_png

        init = decode_png(base64.b64decode(phase3["png_b64"]))[0]
        p = GenerationParams(prompt=base["prompt"], negative_prompt=base["negative_prompt"],
                             steps=ALT_STEPS, cfg_scale=2.0)
        p.all_prompts, p.all_negative_prompts = [p.prompt], [p.negative_prompt]
        with torch.inference_mode():
            latent = processing.encode_first_stage(model, init[None].astype("float32") / 255.0)
            sched = processing._build_conds(model, p, ALT_STEPS + 1)
        sigmas = get_schedule("Automatic", ALT_STEPS, model.disc)[::-1].copy()
        reset_counts()
        noise = [processing.invert_noise(model, sched, latent, sigmas) for _ in range(2)]
        torch.cuda.synchronize()
        launches = read_counts()
        std = float(noise[0].std(unbiased=False))
        repeat = float((noise[0] - noise[1]).abs().max())
        log(f"4m invert_noise: std {std:.6f}, repeat max|Δ| {repeat:.3g} (bound "
            f"{NOISE_REPEAT_TOL}), launches {launches}")
        if not bool(torch.isfinite(noise[0]).all()) or abs(std - 1.0) > 1e-3 \
                or repeat > NOISE_REPEAT_TOL or launches != plan(2 * ALT_STEPS, 0, 0):
            raise AssertionError(f"4m invert_noise: std {std}, repeat {repeat}, "
                                 f"launches {launches}")
        info["invert_noise"] = dict(std=std, repeat_max_abs=repeat, launches=launches)
        results.append(_script_request(url, "img2img", dict(
            i2i, script_name="img2img alternative test",
            script_args=["", "", True, ALT_STEPS, 2.0]), "img2img alternative",
            plan(2 * ALT_STEPS, 2, 3), _img2img_hook_plan(1), rec))
        # (h) an sd_unet provider: its bundle's images, not Automatic's
        neg = copy.deepcopy(model.unet)
        with torch.no_grad():
            for prm in neg.parameters():
                prm.mul_(-1.0)
        bundle = dataclasses.replace(model, unet=neg, network_cache={})
        framework.on("list_unets", lambda lst: lst.append(SdUnetOption("chip-negated",
                                                                       lambda m: bundle)))
        try:
            res = _script_request(url, "txt2img", dict(
                base, override_settings={"sd_unet": "chip-negated"}), "sd_unet provider",
                plan(STEPS, 1, 1), _hook_plan(1), rec)
            own_engine = Engine(model=bundle, device=device,
                                embeddings_dir=engine.embeddings_dir)
            with _server(own_engine) as url2:
                own = _script_request(url2, "txt2img", base, "the provider's bundle",
                                      plan(STEPS, 1, 1), _hook_plan(1), rec)
        finally:
            framework._callbacks["list_unets"].clear()
        automatic = phase3["image"].astype(int)
        delta = int(abs(res["images"][0].astype(int) - own["images"][0].astype(int)).max())
        moved = float(abs(res["images"][0].astype(int) - automatic).mean())
        if delta > REPEAT_TOL or not moved > 1.0:
            raise AssertionError(f"4m sd_unet: max|Δ| {delta} from the bundle's image, mean "
                                 f"|Δ| {moved:.2f} from Automatic's")
        results += [res, own]
        del neg, bundle
        # (i) the main UI's postprocessing: Lanczos x2 after the decode
        res = _script_request(url, "txt2img", dict(base, postprocessing={
            "enable": ["Upscale"], "upscaler_1": "Lanczos", "upscaling_resize": 2}),
            "postprocessing", plan(STEPS, 1, 1), _hook_plan(1), rec, size=(2 * size, 2 * size))
        if "Postprocessing: Upscale" not in res["infotexts"][0]:
            raise AssertionError(f"4m postprocessing infotext: {res['infotexts'][0]!r}")
        results.append(res)
    info["phase_s"] = time.perf_counter() - t_phase
    info["seconds"] = {r["label"]: r["seconds"] for r in results}
    # B1 at the 512² rows of phase 1: the batch-1 decodes (all but SD
    # upscale's batches and the 640-wide outpaint) and f32 encodes
    info["decodes_512"] = 4 + 4 + 2 + 2 + 1 + 2 + 1
    info["f32_encodes_512"] = 2 + 2 + 1
    for r in results:
        del r["images"], r["infotexts"]
    gc.collect()
    torch.cuda.empty_cache()
    return results, info


# each kernel of the kernels line: its TPU source line, its CUDA source and
# the phase-1 row whose times it reports (its dominant main-path shape; for
# B1, which serves only the VAE, the VAE row chosen in main())
#: the kernels the main paths launch (B3 and B4 have entries of their own only)
PATH_KERNELS = ("flash_attention", "flash_attention_packed", "layer_norm")
KERNEL_ENTRIES = [
    ("flash_attention", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:112",
     None, None),
    ("flash_attention_packed", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:311",
     "sdxl_base_64x64", "bfloat16"),
    ("flash_attention_4d", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:432",
     "sdxl_base_64x64", "bfloat16"),
    ("conv3x3", "conv3x3.cu", "sdwebui_tpu/ops/conv.py:76", "jax_doc_64x64x320", "bfloat16"),
    # SDXL base's 1280-wide LayerNorm: 2880 of a config 5 request's 3731 launches
    ("layer_norm", "layer_norm.cu", "sdwebui_tpu/ops/pallas_norms.py:65",
     "sdxl_base_s1024_c1280", "bfloat16"),
]


def _saved_files(root: str) -> dict:
    """{path relative to root: full path} of every file under root."""
    return {os.path.relpath(os.path.join(r, f), root): os.path.join(r, f)
            for r, _, fs in os.walk(root) for f in fs}


def codec_host_ms(image) -> dict:
    """The host ms of the PNG and JPEG codecs (medians of three): a 512²
    sample saved as PNG at level 1 and as JPEG at quality 80 (with its EXIF
    block), JPEG decodes at 512² (quality 80 and 95, 4:2:0 and 4:4:4) and
    at 1024² (quality 80, the sample upscaled 2x)."""
    import importlib.util

    from sdwebui_tpu_torch.utils import exif, images, jpeg
    from sdwebui_tpu_torch.utils.png import encode_png

    # the 4:4:4 files: the test helper's encoder (the port writes 4:2:0 only)
    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_files", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                         "torch_jpeg_files.py"))
    jpeg_files = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jpeg_files)
    text = exif.build_exif_bytes("a photograph\nSteps: 20, Seed: 1")
    big = images.resize(image, (1024, 1024), "lanczos")
    files = {"q80_420": jpeg.encode_jpeg(image, 80), "q95_420": jpeg.encode_jpeg(image, 95),
             "q80_444": jpeg_files.encode_sampled(image, 80, "4:4:4"),
             "q95_444": jpeg_files.encode_sampled(image, 95, "4:4:4"),
             "1024_q80_420": jpeg.encode_jpeg(big, 80)}
    out = {"png_level1_encode_512": host_ms(lambda: encode_png(image, None, level=1)),
           "jpeg_q80_encode_512": host_ms(lambda: jpeg.encode_jpeg(image, 80, text)),
           "jpeg_q80_encode_1024": host_ms(lambda: jpeg.encode_jpeg(big, 80))}
    for name, data in files.items():
        size = "" if name.startswith("1024") else "512_"
        out[f"jpeg_decode_{size}{name}"] = host_ms(lambda: jpeg.decode_jpeg(data))
        out[f"bytes_{size}{name}"] = len(data)
    log("4n codec host ms: " + json.dumps({k: round(v, 2) for k, v in out.items()}))
    return out


def phase_saving(engine, model, phase3: dict, directory: str):
    """4n: saving and JPEG on the phase-3 SD1.5 server, its --outdir a
    temporary directory: (a) txt2img batch 2 in four arms, twice each (a
    third round would take the run past its limit), interleaved: without
    save_images, with it but no file saved (the
    same response), saving on the writer thread and saving inside the
    request, the files (two samples and the grid) equal in pixels and
    infotext to the response; (b) the same with
    samples_format jpg: the JPEGs' UserComment equal to the infotext, each
    the port's encoding of the response's image, decoded within
    JPEG_MEAN_TOL of it on average; (c) img2img from a JPEG init image and from the same pixels as
    a PNG, within REPEAT_TOL; (d) /internal/img2img-batch over 2 JPEGs and 1
    PNG; (e) /internal/save-images with its log.csv row; the codecs' host ms.
    Every generation's B1, B2 and B5 launches equal the plan's.  Returns
    (results, info)."""
    import csv

    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils import exif, jpeg, saving
    from sdwebui_tpu_torch.utils.options import opts
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    outdir = os.path.join(directory, "outputs")
    prev_outdir, engine.outdir = engine.outdir, outdir
    txt_plan = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                     b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    i2i_plan = _plan(b1=2, b2=(t_enc + 1) * launch_plan(model.unet_cfg, 64),
                     b5=(t_enc + 1) * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    results, info = [], {}
    base = dict(SD15_BASE, batch_size=2, seed=2468)

    def generate(route, body, label, plan):
        reset_counts()
        t0 = time.perf_counter()
        res = _post(f"{url}/{route}", body)
        dt = time.perf_counter() - t0
        launches = read_counts()
        log(f"4n {label}: {dt:.3f} s, launches {launches}")
        if launches != plan:
            raise AssertionError(f"4n {label}: launches {launches} != planned {plan}")
        images = [decode_png(base64.b64decode(b)) for b in res["images"]]
        for img, _ in images:
            if img.std() < 1.0:
                raise AssertionError(f"4n {label}: a flat image")
        results.append(dict(route=route, label=f"4n {label}", batch=body.get("batch_size", 1),
                            seed=body["seed"], seconds=dt, launches=launches))
        return res, images, dt

    try:
        with _server(engine) as url:
            _post(f"{url}/txt2img", dict(SD15_BASE, seed=1, steps=2))       # warm-up
            # (a) the save's cost, four arms interleaved: without
            # save_images (two images, no grid); with it but samples_save
            # and grid_save off (the same response as a saving request: the
            # grid and two images, no file); with it and sdtpu_async_save on
            # (the writer thread) and off (the writes inside the request)
            arms = {"save_off": {"save_images": False},
                    "grid_no_files": {"save_images": True, "override_settings": {
                        "samples_save": False, "grid_save": False}},
                    "save_async": {"save_images": True},
                    "save_sync": {"save_images": True, "override_settings": {
                        "sdtpu_async_save": False}}}
            info["txt2img_s"] = {arm: [] for arm in arms}
            order = list(arms) + list(arms)[::-1]
            for arm in order:
                before = set(_saved_files(outdir)) if os.path.isdir(outdir) else set()
                res, images, dt = generate("txt2img", dict(base, **arms[arm]),
                                           f"txt2img batch 2 {arm}", txt_plan)
                info["txt2img_s"][arm].append(dt)
                listed = set(_saved_files(outdir)) if os.path.isdir(outdir) else set()
                saving.flush_saves()
                written = sorted(set(_saved_files(outdir)) - before) \
                    if os.path.isdir(outdir) else []
                if len(images) != (2 if arm == "save_off" else 3):
                    raise AssertionError(f"4n {arm}: {len(images)} images in the response")
                if arm in ("save_off", "grid_no_files"):
                    if written:
                        raise AssertionError(f"4n {arm}: the request wrote {written}")
                    continue
                if arm == "save_sync" and sorted(listed - before) != written:
                    raise AssertionError(f"4n save_sync: {sorted(listed - before)} on disk when "
                                         f"the response came, {written} after the flush")
                saved_names = written
                if len(written) != 3 or sum("txt2img-grids" in f for f in written) != 1:
                    raise AssertionError(f"4n: save_images wrote {written}")
                files = _saved_files(outdir)
                grid = [f for f in written if "txt2img-grids" in f]
                samples = [f for f in written if f not in grid]
                for name, (img, text) in zip(grid + samples, images):
                    saved, saved_text = decode_png(open(files[name], "rb").read())
                    if not (saved == img).all() or saved_text != text:
                        raise AssertionError(f"4n: {name} differs from the response's image")
                saved_res = res
            log("4n txt2img s by arm: " + json.dumps(info["txt2img_s"]))
            log(f"4n save_images: {saved_names} equal to the response in pixels and infotext")
            # (b) samples_format jpg
            res, images, _ = generate("txt2img", dict(
                base, save_images=True, override_settings={"samples_format": "jpg"}),
                "txt2img batch 2 samples_format jpg", txt_plan)
            saving.flush_saves()
            jpgs = sorted(f for f in _saved_files(outdir) if f.endswith(".jpg"))
            if len(jpgs) != 2:
                raise AssertionError(f"4n: samples_format jpg wrote {jpgs}")
            means, q95 = [], []
            for name, (img, text) in zip(jpgs, images[1:]):
                data = open(os.path.join(outdir, name), "rb").read()
                pixels, jinfo = jpeg.decode_jpeg(data)
                if exif.read_user_comment(jinfo.get("exif")) != text["parameters"]:
                    raise AssertionError(f"4n: {name}'s UserComment is not the infotext")
                if data != jpeg.encode_jpeg(img, opts.get("jpeg_quality"),
                                            exif.build_exif_bytes(text["parameters"])):
                    raise AssertionError(f"4n: {name} is not the encoding of the response")
                means.append(float(abs(pixels.astype(int) - img.astype(int)).mean()))
                q95.append(float(abs(jpeg.decode_jpeg_rgb(jpeg.encode_jpeg(img, 95)).astype(int)
                                     - img.astype(int)).mean()))
            log(f"4n samples_format jpg: {jpgs}, the encodings of the responses, mean|Δ| "
                f"{means} levels (bound {JPEG_MEAN_TOL}; at quality 95 {q95})")
            if max(means) > JPEG_MEAN_TOL:
                raise AssertionError(f"4n: the JPEGs differ by {means} levels on average")
            info["jpeg_mean_levels"], info["jpeg_q95_mean_levels"] = means, q95
            # (c) img2img from a JPEG init image and from its pixels as a PNG
            sample = phase3["image"]
            init_jpg = jpeg.encode_jpeg(sample, 90)
            init_png = encode_png(jpeg.decode_jpeg_rgb(init_jpg))
            i2i = dict(SD15_BASE, denoising_strength=DENOISE, seed=1357)
            outs = {}
            for kind, data in (("jpeg", init_jpg), ("png", init_png), ("jpeg", init_jpg),
                               ("png", init_png)):
                res, images, dt = generate("img2img", dict(
                    i2i, init_images=[base64.b64encode(data).decode()]),
                    f"img2img from a {kind} init image", i2i_plan)
                outs.setdefault(kind, []).append((images[-1][0], dt))
            delta = int(abs(outs["jpeg"][0][0].astype(int) - outs["png"][0][0].astype(int)).max())
            log(f"4n img2img: the JPEG init's image within {delta} levels of the PNG's "
                f"(bound {REPEAT_TOL})")
            if delta > REPEAT_TOL:
                raise AssertionError(f"4n: the JPEG init image's answer differs by {delta}")
            info["img2img_s"] = {k: [dt for _, dt in v] for k, v in outs.items()}
            # (d) the img2img batch over 2 JPEGs and 1 PNG
            src, dst = os.path.join(directory, "batch_in"), os.path.join(directory, "batch_out")
            os.makedirs(src)
            for name, data in (("a.jpg", init_jpg), ("b.png", encode_png(sample)),
                               ("c.jpeg", jpeg.encode_jpeg(sample[::-1].copy(), 80))):
                with open(os.path.join(src, name), "wb") as f:
                    f.write(data)
            reset_counts()
            t0 = time.perf_counter()
            res = _post(url.replace("/sdapi/v1", "/internal/img2img-batch"), dict(
                i2i, input_dir=src, output_dir=dst))
            dt = time.perf_counter() - t0
            launches = read_counts()
            planned = {k: 3 * v for k, v in i2i_plan.items()}
            log(f"4n img2img-batch of 3 files: {dt:.3f} s, launches {launches}")
            if launches != planned or sorted(os.listdir(dst)) != ["a.png", "b.png", "c.png"] \
                    or res["processed"] != 3:
                raise AssertionError(f"4n img2img-batch: {res['outputs']}, launches {launches}"
                                     f" != planned {planned}")
            for name in os.listdir(dst):
                img, text = decode_png(open(os.path.join(dst, name), "rb").read())
                if img.shape != sample.shape or img.std() < 1.0 or "Seed: 1357" not in \
                        text.get("parameters", ""):
                    raise AssertionError(f"4n img2img-batch: {name} is wrong")
            results.append(dict(route="img2img-batch", label="4n img2img-batch", batch=3,
                                seed=1357, seconds=dt, launches=launches))
            info["img2img_batch_s"] = dt
            # (e) the gallery's Save button: the last saved txt2img posted back
            save_dir = os.path.join(directory, "saved")
            prev_save = opts.get("outdir_save")
            _post(f"{url}/options", {"outdir_save": save_dir})
            try:
                reset_counts()
                res = _post(url.replace("/sdapi/v1", "/internal/save-images"), {
                    "info": saved_res["info"], "images": saved_res["images"],
                    "do_make_zip": True})
                if read_counts() != _plan():
                    raise AssertionError("4n: save-images launched a kernel")
            finally:
                _post(f"{url}/options", {"outdir_save": prev_save})
            files = _saved_files(save_dir)
            with open(files["log.csv"], newline="") as f:
                rows = list(csv.reader(f))
            if len(res["files"]) != 3 or not res["zip"] or len(files) != 5 or \
                    rows[1][:2] != [SD15_BASE["prompt"], str(base["seed"])]:
                raise AssertionError(f"4n save-images: {sorted(files)}, log.csv {rows}")
            log(f"4n save-images: {sorted(files)}, log.csv row {rows[1]}")
    finally:
        engine.outdir = prev_outdir
    info["codec_ms"] = codec_host_ms(phase3["image"])
    # the VAE's launches at 512² for B1's row: a decode an image batch (the
    # warm-up's too), and an f32 encode an init image
    encodes = sum(r["batch"] for r in results if r["route"].startswith("img2img"))
    info["decodes_512"] = 1 + sum(r["batch"] if r["route"] == "img2img-batch" else 1
                                  for r in results)
    info["f32_encodes_512"] = encodes
    return results, info


# lossy WebP (quality 80) and a 256-colour GIF of a random-weight sample:
# mean uint8 levels from the response's pixels.  The CPU tests hold both
# codecs within 1.25x the mean error of Pillow's own files; the card has no
# Pillow, so these are sanity bounds, as JPEG_MEAN_TOL is for JPEG
WEBP_MEAN_TOL = 20
GIF_MEAN_TOL = 24
PREVIEW_EVERY = 10        # 4o (e): a Full live preview every 10 steps, the option's default


def _image_files_helper():
    """tests/torch_image_files.py: the writers of the variants the port reads
    and never writes (RLE BMP, LZW and Deflate TIFF, 16-bit and interlaced
    PNG), loaded by path as 4n loads torch_jpeg_files."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_image_files", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                          "torch_image_files.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def format_files(sample) -> tuple:
    """The init image in every format 4o sends → ({name: (bytes, reference
    key)}, {reference key: PNG bytes of the pixels those files decode to}):
    the lossless files decode to the sample, the GIF and the RLE8 BMP to
    its 256-colour quantization, the lossy WebPs to their own decodes."""
    from sdwebui_tpu_torch.utils import bmp, gif, webp
    from sdwebui_tpu_torch.utils.png import encode_png

    files = _image_files_helper()
    h, w = sample.shape[:2]
    pal, index = gif.quantize(sample.reshape(-1, 3))
    quant = pal[index].reshape(sample.shape)
    alpha = torch.linspace(64, 255, w).to(torch.uint8).view(1, w, 1).expand(h, w, 1)
    rgba = torch.cat([torch.from_numpy(sample), alpha], dim=2).numpy()
    noise = torch.randint(0, 256, sample.shape, generator=torch.Generator().manual_seed(4),
                          dtype=torch.int32).numpy().astype("uint16")
    lossy, with_alpha = webp.encode_webp(sample, 80), webp.encode_webp_alpha(rgba, 80)
    out = {"webp_lossless": (webp.encode_webp(sample, lossless=True), "sample"),
           "webp_lossy": (lossy, "lossy"), "webp_lossy_alpha": (with_alpha, "alpha"),
           "gif": (gif.encode_gif(sample), "quant"), "bmp_24": (bmp.encode_bmp(sample), "sample"),
           "bmp_rle8": (files.bmp_file(index.reshape(h, w).astype("uint8"), "rle8", pal),
                        "quant"),
           "tiff_lzw_predictor": (files.tiff_file(sample, "lzw", True, rows_per_strip=64),
                                  "sample"),
           "tiff_deflate": (files.tiff_file(sample, "deflate", rows_per_strip=64), "sample"),
           "png_16bit": (files.png_file((sample.astype("uint16") << 8) | noise, 16, 2),
                         "sample"),
           "png_interlaced": (files.png_file(sample, 8, 2, interlace=True), "sample")}
    refs = {"sample": encode_png(sample), "quant": encode_png(quant),
            "lossy": encode_png(webp.decode_webp(lossy)[0]),
            "alpha": encode_png(webp.decode_webp(with_alpha)[0])}
    return out, refs


def format_codec_ms(image) -> dict:
    """The host ms of the new codecs (medians of three) on a 512² sample:
    WebP lossy (quality 80) and lossless, GIF, BMP and TIFF, each encoded
    and decoded; the variants only read (RLE8 BMP, LZW TIFF, 16-bit and
    interlaced PNG) decoded; a 1024² WebP (lossless) both ways."""
    from sdwebui_tpu_torch.utils import bmp, gif, images, tiff, webp
    from sdwebui_tpu_torch.utils.image_io import decode_image

    files = _image_files_helper()
    out = {}
    writers = {"webp_lossy": lambda a: webp.encode_webp(a, 80),
               "webp_lossless": lambda a: webp.encode_webp(a, lossless=True),
               "gif": lambda a: gif.encode_gif(a, "a photograph"), "bmp": bmp.encode_bmp,
               "tiff": tiff.encode_tiff}
    for name, write in writers.items():
        out[f"{name}_encode_512"] = host_ms(lambda: write(image))
        data = write(image)
        out[f"{name}_decode_512"] = host_ms(lambda: decode_image(data))
        out[f"bytes_{name}_512"] = len(data)
    pal, index = gif.quantize(image.reshape(-1, 3))
    read_only = {"bmp_rle8": files.bmp_file(index.reshape(image.shape[:2]).astype("uint8"),
                                            "rle8", pal),
                 "tiff_lzw_predictor": files.tiff_file(image, "lzw", True, rows_per_strip=64),
                 "png_16bit": files.png_file(image.astype("uint16") << 8, 16, 2),
                 "png_interlaced": files.png_file(image, 8, 2, interlace=True)}
    for name, data in read_only.items():
        out[f"{name}_decode_512"] = host_ms(lambda: decode_image(data))
    big = images.resize(image, (1024, 1024), "lanczos")
    out["webp_lossless_encode_1024"] = host_ms(lambda: webp.encode_webp(big, lossless=True))
    data = webp.encode_webp(big, lossless=True)
    out["webp_lossless_decode_1024"] = host_ms(lambda: decode_image(data))
    out["bytes_webp_lossless_1024"] = len(data)
    log("4o codec host ms: " + json.dumps({k: round(v, 2) for k, v in out.items()}))
    return out


def preview_jobs(url, root, txt_plan: dict, results: list) -> dict:
    """4o (e): the same 512² txt2img with a Full live preview every
    PREVIEW_EVERY steps while the UI's poller fetches each preview from
    /internal/progress, in png and then in webp (the lossy encoder runs
    in the poll's handler, beside the sampling thread) → {format: seconds
    of the request, previews fetched, polls}.  Each launches B2 and B5 as
    planned and B1 once more for each preview's VAE decode."""
    keys = ("live_previews_image_format", "show_progress_type", "show_progress_every_n_steps")
    current = _post(f"{url}/options")
    before = {k: current[k] for k in keys}
    plan = dict(txt_plan, flash_attention=txt_plan["flash_attention"] + STEPS // PREVIEW_EVERY)
    out = {}
    try:
        for fmt in ("png", "webp"):
            _post(f"{url}/options", {"live_previews_image_format": fmt, "show_progress_type": "Full",
                                     "show_progress_every_n_steps": PREVIEW_EVERY})
            fetched = {}

            def fetch(p):
                live = _post(f"{root}/internal/progress",
                             {"id_task": "chip_smoke", "live_preview": True})
                if live["live_preview"]:
                    fetched[live["id_live_preview"]] = live["live_preview"].split(",", 1)[0]

            job, launches, polls = _watched_job(url, root, dict(SD15_BASE, seed=98), fetch)
            label = f"4o (e) txt2img with {fmt} Full previews"
            log(f"{label}: {job['seconds']:.3f} s, {len(fetched)} previews fetched in "
                f"{len(polls)} polls, launches {launches}")
            if launches != plan:
                raise AssertionError(f"{label}: launches {launches} != planned {plan}")
            if not fetched or set(fetched.values()) != {f"data:image/{fmt};base64"}:
                raise AssertionError(f"{label}: previews {fetched}")
            results.append(dict(route="txt2img", label=label, batch=1, seed=98,
                                seconds=job["seconds"], launches=launches))
            out[fmt] = dict(seconds=job["seconds"], previews=len(fetched), polls=len(polls))
    finally:
        _post(f"{url}/options", before)
    log(f"4o (e) s/request with Full previews every {PREVIEW_EVERY} steps: "
        + json.dumps(out))
    return out


def phase_formats(engine, model, phase3: dict, directory: str):
    """4o: the image formats after JPEG on the phase-3 SD1.5 server, its
    --outdir a temporary directory: (a) img2img from one init image in
    every format of format_files, each within REPEAT_TOL of the img2img
    from a PNG of the same decoded pixels (the decode checked equal to it
    first); (b) txt2img batch 1 saving with samples_format webp (lossy,
    then webp_lossless), gif, bmp and tiff: each file's decode equal to the
    response's pixels (lossless) or within WEBP_MEAN_TOL / GIF_MEAN_TOL of
    them, the WebP's infotext back through /png-info; (c) a webp live
    preview from /internal/progress during a job; (d) the codecs' host ms;
    (e) preview_jobs: a job's seconds with png and with webp Full previews.
    Every request but (c)'s launches B1, B2 and B5 as planned.  Returns
    (results, info)."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils import saving
    from sdwebui_tpu_torch.utils.image_io import decode_image
    from sdwebui_tpu_torch.utils.png import decode_png

    outdir = os.path.join(directory, "outputs")
    prev_outdir, engine.outdir = engine.outdir, outdir
    txt_plan = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                     b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    i2i_plan = _plan(b1=2, b2=(t_enc + 1) * launch_plan(model.unet_cfg, 64),
                     b5=(t_enc + 1) * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    results, info = [], {}
    sample = phase3["image"]

    def generate(route, body, label, plan):
        reset_counts()
        t0 = time.perf_counter()
        res = _post(f"{url}/{route}", body)
        dt = time.perf_counter() - t0
        launches = read_counts()
        log(f"4o {label}: {dt:.3f} s, launches {launches}")
        if launches != plan:
            raise AssertionError(f"4o {label}: launches {launches} != planned {plan}")
        images = [decode_png(base64.b64decode(b)) for b in res["images"]]
        if any(img.std() < 1.0 for img, _ in images):
            raise AssertionError(f"4o {label}: a flat image")
        results.append(dict(route=route, label=f"4o {label}", batch=1, seed=body["seed"],
                            seconds=dt, launches=launches))
        return res, images

    t0 = time.perf_counter()
    files, refs = format_files(sample)
    info["files_s"] = time.perf_counter() - t0
    info["bytes"] = {name: len(data) for name, (data, _) in files.items()}
    for name, (data, key) in files.items():
        got = decode_image(data)[0]
        want = decode_png(refs[key])[0]
        if got.shape != want.shape or not (got == want).all():
            raise AssertionError(f"4o: {name} does not decode to its reference pixels")
    log(f"4o wrote and checked {len(files)} files in {info['files_s']:.2f} s: "
        + json.dumps(info["bytes"]))
    try:
        with _server(engine) as url:
            root = url.rsplit("/sdapi/v1", 1)[0]
            # (a) img2img from each format against the PNG of its pixels
            i2i = dict(SD15_BASE, denoising_strength=DENOISE, seed=2468)
            ref_out, deltas = {}, {}
            for key, data in refs.items():
                _, images = generate("img2img", dict(i2i, init_images=[
                    base64.b64encode(data).decode()]), f"img2img from the {key} PNG", i2i_plan)
                ref_out[key] = images[-1][0]
            # one file of each reference PNG (every file's decode was checked
            # equal to its pixels above; every file's img2img would take the
            # run past its limit)
            firsts = {}
            for name, (data, key) in files.items():
                firsts.setdefault(key, name)
            for name, (data, key) in files.items():
                if firsts[key] != name:
                    continue
                _, images = generate("img2img", dict(i2i, init_images=[
                    base64.b64encode(data).decode()]), f"img2img from {name}", i2i_plan)
                deltas[name] = int(abs(images[-1][0].astype(int)
                                       - ref_out[key].astype(int)).max())
            log(f"4o (a) max|Δ| against the PNG of the same pixels: {json.dumps(deltas)} "
                f"(bound {REPEAT_TOL})")
            if max(deltas.values()) > REPEAT_TOL:
                raise AssertionError(f"4o: img2img from a format differs from its PNG: {deltas}")
            info["img2img_max_delta"] = deltas
            # (b) saving in each format
            saved = {}
            for label, fmt, extra in (("webp", "webp", {}),
                                      ("webp_lossless", "webp", {"webp_lossless": True}),
                                      ("gif", "gif", {}), ("bmp", "bmp", {}),
                                      ("tiff", "tiff", {})):
                before = set(_saved_files(outdir)) if os.path.isdir(outdir) else set()
                res, images = generate("txt2img", dict(
                    SD15_BASE, seed=1357, save_images=True, override_settings=dict(
                        samples_format=fmt, **extra)), f"txt2img saving {label}", txt_plan)
                saving.flush_saves()
                written = sorted(set(_saved_files(outdir)) - before)
                if len(written) != 1 or not written[0].endswith("." + fmt):
                    raise AssertionError(f"4o {label}: wrote {written}")
                data = open(os.path.join(outdir, written[0]), "rb").read()
                got, _ = decode_image(data)
                shown = images[0][0]
                mean = float(abs(got.astype(int) - shown.astype(int)).mean())
                bound = {"webp": WEBP_MEAN_TOL, "gif": GIF_MEAN_TOL}.get(label, 0)
                saved[label] = dict(file=written[0], bytes=len(data), mean_levels=mean)
                if got.shape != shown.shape or mean > bound or (bound == 0 and mean != 0):
                    raise AssertionError(f"4o {label}: {written[0]} is {mean:.2f} levels from "
                                         f"the response on average (bound {bound})")
                if fmt == "webp":
                    text = json.loads(res["info"])["infotexts"][0]
                    back = _post(f"{url}/png-info", {"image": base64.b64encode(data).decode()})
                    if back["info"] != text:
                        raise AssertionError(f"4o {label}: png-info gave {back['info']!r}")
            log("4o (b) saved: " + json.dumps(saved))
            info["saved"] = saved
            # (c) a webp live preview during a job
            prev_fmt = _post(f"{url}/options")["live_previews_image_format"]
            _post(f"{url}/options", {"live_previews_image_format": "webp"})
            seen = {}

            def grab(p):
                if "preview" not in seen and p["state"]["sampling_step"] >= 5:
                    live = _post(f"{root}/internal/progress",
                                 {"id_task": "chip_smoke", "live_preview": True})
                    if live["live_preview"]:
                        seen["preview"] = live["live_preview"]

            try:
                _watched_job(url, root, dict(SD15_BASE, seed=97), grab)
            finally:
                _post(f"{url}/options", {"live_previews_image_format": prev_fmt})
            if "preview" not in seen:
                raise AssertionError("4o (c): no live preview came")
            head, b64 = seen["preview"].split(",", 1)
            preview = decode_image(base64.b64decode(b64))[0]
            if head != "data:image/webp;base64" or preview.ndim != 3 or preview.std() < 1.0:
                raise AssertionError(f"4o (c): the preview is {head}, {preview.shape}")
            info["live_preview"] = dict(head=head, shape=list(preview.shape),
                                        bytes=len(base64.b64decode(b64)))
            log(f"4o (c) live preview: {info['live_preview']}")
            info["preview_jobs"] = preview_jobs(url, root, txt_plan, results)
    finally:
        engine.outdir = prev_outdir
    info["codec_ms"] = format_codec_ms(sample)
    info["f32_encodes_512"] = sum(r["route"] == "img2img" for r in results)
    info["decodes_512"] = sum(r["launches"]["flash_attention"] for r in results) \
        - info["f32_encodes_512"]
    return results, info


UI_MERGE_M = 0.5          # 4p (i): Weighted sum's multiplier
UI_ADD_M = 0.7            # 4p (ii): Add difference's, with tertiary = secondary
UI_BREAK_PROMPT = "a (red:1.2) astronaut, [oil painting] BREAK a horse on the moon, stars"
#: JAX's /internal/token-count of UI_BREAK_PROMPT over the fallback CLIP
#: tokenizer (tests/test_torch_ui_routes.py holds it to JAX's Api on the CPU)
UI_BREAK_TOKENS = {"token_count": 96, "max_length": 150}


def _trace_kernels(path: str) -> dict:
    """Kernel launches of a Chrome trace by class: B2's and B1's attention
    kernels and B5's LayerNorm kernels by name, and every kernel."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in sorted(
        (e for e in events if e.get("cat") == "kernel"), key=lambda e: e.get("ts", 0))]
    return dict(first=[k[:60] for k in kernels[:6]], last=[k[:60] for k in kernels[-3:]],
                attn_tc_kernel=sum("attn_tc_kernel" in k for k in kernels),
                attn_wide_kernel=sum("attn_wide_kernel" in k for k in kernels),
                layer_norm=sum("layer_norm_reg_kernel" in k or "layer_norm_kernel" in k
                               for k in kernels),
                all=len(kernels), events=len(events), mb=os.path.getsize(path) / 1e6)


def phase_ui(model, device, phase3: dict, directory: str):
    """4p: the page and the checkpoint merger on a server over two files in a
    temporary directory, served as --ckpt-dir serves them: phase 3's model
    in its own dtypes and a random SD1.5 of seed 2 in fp16.  (a) GET /
    answers the port's page; (b) /sdapi/v1/modelmerger, (i) Weighted sum
    0.5 with save_as_half: the file equal tensor for tensor to this phase's
    own merge of the same files on the card and on the CPU, listed after
    /refresh-checkpoints, a seed-1234 txt2img from it through
    override_settings twice (finite, not phase 3's image, the repeat within
    REPEAT_TOL); (ii) Add difference with tertiary = secondary: the file's
    tensors equal the primary's, its image within REPEAT_TOL of phase 3's;
    (c) parse-infotext of (i)'s infotext, token-count of a BREAK prompt
    against JAX's count (UI_BREAK_TOKENS), last-result against the last
    response;
    (d) one (i) request with profiling_enable: its Chrome trace names B2's
    and B5's kernels as often as the plan launches them, and loses no
    kernel record of the request (its launches matched to kernel records
    by correlation id, utils/profiling.last_lost) behind utils/profiling's
    pad kernels; (e) /internal/sysinfo
    names the card.  Every txt2img launches B1 1, B2 200 and B5 986.
    Returns (results, info)."""
    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict, write_safetensors
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.postprocessing.merger import merge_checkpoints
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils import profiling

    _need_disk(directory, 12.0)
    primary = os.path.join(directory, "chip-sd15.safetensors")
    secondary = os.path.join(directory, "chip-sd15-seed2-fp16.safetensors")
    write_safetensors(primary, load.ldm_state_dict(model), metadata={"format": "pt"})
    other = create_random_sd15(seed=2, device=device)
    write_safetensors(secondary, {k: v.half() for k, v in load.ldm_state_dict(other).items()})
    del other
    torch.cuda.empty_cache()
    engine = Engine(device=device, ckpt=primary, ckpt_dirs=[directory],
                    hash_cache=os.path.join(directory, "hashes.json"))
    plan = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                 b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    body = dict(SD15_BASE, seed=1234, batch_size=1)
    results, info = [], {}

    size = SD15_BASE["width"]

    def request(url, name, label):
        return _request(url, "txt2img", dict(body, override_settings={
            "sd_model_checkpoint": name}), _sd15_check, size, f"4p {label}")

    with _server(engine) as url:
        root = url[: -len("/sdapi/v1")]
        # (a) the page
        ms, page = _get_raw(root + "/")
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "sdwebui_tpu_torch",
                               "server", "webui.html"), "rb") as f:
            if page != f.read():
                raise AssertionError("4p (a): GET / is not the port's page")
        info["page"] = dict(ms=ms, bytes=len(page))
        # (b) (i) Weighted sum with save_as_half
        merges = {}
        for label, req in (("weighted", dict(secondary_model=os.path.basename(secondary),
                                             interp_method="Weighted sum",
                                             multiplier=UI_MERGE_M, save_as_half=True,
                                             custom_name="chip-ws")),
                           ("add_difference", dict(secondary_model=os.path.basename(secondary),
                                                   tertiary_model=os.path.basename(secondary),
                                                   interp_method="Add difference",
                                                   multiplier=UI_ADD_M, custom_name="chip-ad"))):
            t0 = time.perf_counter()
            answer = _post(f"{url}/modelmerger", dict(req, primary_model=primary))
            seconds = time.perf_counter() - t0
            out = os.path.join(directory, req["custom_name"] + ".safetensors")
            if answer != {"info": f"merged checkpoint saved to {out}"}:
                raise AssertionError(f"4p (b) {label}: {answer}")
            moved = sum(os.path.getsize(p) for p in (primary, secondary, out)) + \
                (os.path.getsize(secondary) if "tertiary_model" in req else 0)
            merges[label] = dict(seconds=seconds, gb_moved=moved / 1e9, gb_per_s=moved / 1e9
                                 / seconds, file_gb=os.path.getsize(out) / 1e9, path=out)
            log(f"4p (b) {label} merge: {seconds:.3f} s, {moved / 1e9:.3f} GB read and "
                f"written, {moved / 1e9 / seconds:.3f} GB/s")
        info["merges"] = merges
        a, b = read_state_dict(primary), read_state_dict(secondary)
        written = read_state_dict(merges["weighted"]["path"])
        for where in (torch.device(device).type, "cpu"):
            t0 = time.perf_counter()
            mine = merge_checkpoints(a, b, None, "Weighted sum", UI_MERGE_M, True, device=where)
            merges["weighted"][f"{where}_merge_s"] = time.perf_counter() - t0
            bad = [k for k in written if not torch.equal(written[k], mine[k])]
            if list(mine) != list(written) or bad:
                raise AssertionError(f"4p (b)(i): the file differs from the {where} merge at "
                                     f"{bad[:3]}")
            del mine
        added = read_state_dict(merges["add_difference"]["path"])
        bad = [k for k in a if not torch.equal(added[k], a[k].float())]
        if list(added) != list(a) or bad:
            raise AssertionError(f"4p (b)(ii): Add difference changed {bad[:3]}")
        del a, b, written, added
        log("4p (b): the Weighted sum file is torch.equal to the merge on the card and on the "
            "CPU (" + ", ".join(f"{w} {merges['weighted'][w + '_merge_s']:.3f} s"
                                for w in (torch.device(device).type, "cpu"))
            + "); the Add difference file equals the primary")
        _post(f"{url}/refresh-checkpoints", {})
        listed = {m["model_name"] for m in _post(f"{url}/sd-models")}
        if not {"chip-ws", "chip-ad"} <= listed:
            raise AssertionError(f"4p (b): sd-models lists {sorted(listed)}")
        results += [request(url, "chip-ws", "(i) weighted sum"),
                    request(url, "chip-ws", "(i) repeat")]
        _check_repeat(results, 0, 1)
        diff = float(abs(results[0]["image"].astype(int) - phase3["image"].astype(int)).mean())
        if not diff > 1.0:
            raise AssertionError(f"4p (i): mean|Δ| {diff:.2f} from phase 3's image")
        # (c) the UI's routes
        last = _post(f"{root}/internal/last-result")
        if last["images"][-1] != results[1]["png_b64"] or \
                json.loads(last["info"])["infotexts"][0] != results[1]["infotext"]:
            raise AssertionError("4p (c): last-result is not the last response")
        parsed = _post(f"{root}/internal/parse-infotext", {"text": results[1]["infotext"]})
        want = {"Seed": "1234", "Steps": str(STEPS), "Sampler": "Euler a",
                "CFG scale": str(SD15_BASE["cfg_scale"]), "Size-1": size, "Size-2": size}
        got = {k: parsed["parsed"].get(k) for k in want}
        if got != want:
            raise AssertionError(f"4p (c): parse-infotext gave {got}, not {want}")
        counted = _post(f"{root}/internal/token-count", {"text": UI_BREAK_PROMPT})
        tokenizer = type(engine.sd_model.conditioner.tokenizer).__name__
        if tokenizer != "FallbackTokenizer" or counted != UI_BREAK_TOKENS:
            raise AssertionError(f"4p (c): token-count {counted} over {tokenizer}, JAX's "
                                 f"{UI_BREAK_TOKENS} over FallbackTokenizer")
        info["token_count"] = counted
        # (d) a profiled request
        trace = os.path.join(directory, "traces", "chip-ws.json")
        t0 = time.perf_counter()
        profiled = _request(url, "txt2img", dict(body, override_settings={
            "sd_model_checkpoint": "chip-ws", "profiling_enable": True,
            "profiling_filename": trace, "profiling_activities": ["CPU"],
            "profiling_with_stack": False, "profiling_record_shapes": False,
            "profiling_profile_memory": False}), _sd15_check, size, "4p (d) profiled")
        profiled["seconds"] = time.perf_counter() - t0
        results.append(profiled)
        seen = _trace_kernels(trace)
        seen["pad_kept"] = profiling.last_pad_kept
        seen["lost"] = profiling.last_lost
        plain_s = results[1]["seconds"]         # the repeat: the same model, no load
        info["profile"] = dict(seconds=profiled["seconds"], unprofiled_s=plain_s,
                               overhead_s=profiled["seconds"] - plain_s, trace=seen)
        log(f"4p (d) profiled request {profiled['seconds']:.3f} s against {plain_s:.3f} s "
            f"unprofiled; its trace: {seen} (kept {seen['pad_kept']} of "
            f"{profiling.PAD_KERNELS} pad kernels; the request's launches with no kernel "
            f"record, by correlation id: {seen['lost']})")
        if (seen["attn_tc_kernel"], seen["layer_norm"], seen["attn_wide_kernel"]) != \
                (plan["flash_attention_packed"], plan["layer_norm"], plan["flash_attention"]) \
                or seen["lost"] != 0:
            raise AssertionError(f"4p (d): the trace names {seen}, planned {plan}, and must "
                                 "lose none of the request's kernel records")
        # (ii) Add difference: phase 3's image again
        results.append(request(url, "chip-ad", "(ii) add difference"))
        back = int(abs(results[-1]["image"].astype(int) - phase3["image"].astype(int)).max())
        log(f"4p (ii): {back} levels from phase 3's image (bound {REPEAT_TOL}); (i) mean|Δ| "
            f"{diff:.2f} from it")
        if back > REPEAT_TOL:
            raise AssertionError(f"4p (ii): {back} levels from phase 3's image")
        # (e) the system report
        sysinfo = _post(f"{root}/internal/sysinfo")
        card = (sysinfo.get("backend"), sysinfo.get("device_name"), sysinfo.get("device_count"))
        cuda = torch.device(device).type == "cuda"
        if card != (torch.device(device).type, torch.cuda.get_device_name(0) if cuda else None,
                    torch.cuda.device_count() if cuda else 1):
            raise AssertionError(f"4p (e): sysinfo names {card}")
        info["sysinfo"] = dict(device_name=card[1], torch=sysinfo["torch"])
    _check_launches(results, [plan] * len(results))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return results, info


# --------------------------------------------------------------------------
# 4q: the parallel runtime on meshes that name the card several times
# --------------------------------------------------------------------------

DP_DATA = 4               # 4q (a): the data axis, the card named four times
# uint8 levels: data=4 image i against one device's batch-1 request of seed + i
# (the same rows through the same kernels); one device's batch-4 images, whose
# GEMMs run over 8 rows, are logged beside it as the yardstick
DP_TOL = 0
TP_TOL = 1                # uint8 levels: f32 tensor-parallel vs one device
TP_STEPS = 4              # 4q (b)'s steps: every op of the model shards hands the GIL over
# uint8 levels (max, mean): a row-sharded 1024² decode against the whole one; in
# bf16 the shards' convs round apart (measured 4, 0.42; the whole decode's bf16
# vs f32 is logged beside it)
ROWS_TOL = {torch.bfloat16: (8, 1.0), torch.float32: (1, 0.05)}
RING_SHAPE = (1, 8, 16384, 64)
TRAIN_LOSS_TOL = 1e-5     # relative: the (data=2, model=2) step's loss vs one device's
TRAIN_PARAM_TOL = 1e-5    # max|Δ| / max|p| over the UNet after the step, f32, TF32 off
TRAIN_GRAD_TOL = 1e-4     # max|Δ| / max|g| over the UNet's gradients
# the update Δp = p after − p before: max|Δp − Δp_one| / max|Δp_one| over the
# elements whose one-device gradient is above TRAIN_ROUNDING of the largest |g|
# (below it Adam turns rounding into steps of up to lr).  One f32 ulp of a
# parameter just above 1 is 1.2e-2 of lr = 1e-5; a skipped update reads 1
TRAIN_UPDATE_TOL = 2e-2
TRAIN_ROUNDING = 1e-6
TRAIN_MOVED_TOL = 0.05    # |max|Δp| / max|Δp_one| − 1|


@contextlib.contextmanager
def _attention_shapes():
    """Records (entry, q shape, k shape, heads) of every B1 / B2 call the
    attention dispatch makes inside the block (ops.attention's names)."""
    from sdwebui_tpu_torch.ops import attention

    seen, lock = [], threading.Lock()
    real = attention.flash_attention, attention.flash_attention_packed

    def b1(q, k, v, **kw):
        with lock:
            seen.append(("flash_attention", tuple(q.shape), tuple(k.shape), 1))
        return real[0](q, k, v, **kw)

    def b2(q, k, v, num_heads, **kw):
        with lock:
            seen.append(("flash_attention_packed", tuple(q.shape), tuple(k.shape), num_heads))
        return real[1](q, k, v, num_heads=num_heads, **kw)

    attention.flash_attention, attention.flash_attention_packed = b1, b2
    try:
        yield seen
    finally:
        attention.flash_attention, attention.flash_attention_packed = real


def _check_shapes(seen, want: set, label: str):
    got = {(e, q, k, h) for e, q, k, h in seen}
    log(f"{label}: kernel shapes {sorted(got)}")
    if got != want:
        raise AssertionError(f"{label}: kernel shapes {sorted(got)} != planned {sorted(want)}")


def _levels(a, b) -> dict:
    d = abs(a.astype(int) - b.astype(int))
    return dict(max=int(d.max()), mean=float(d.mean()))


def _images_within(label, got: list, ref: list, tol: int, mean_tol: float = 1.0) -> list:
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} images against {len(ref)}")
    levels = [_levels(a, b) for a, b in zip(got, ref)]
    log(f"{label}: uint8 levels vs one device {levels} (bound {tol}, mean {mean_tol})")
    if max(lv["max"] for lv in levels) > tol or max(lv["mean"] for lv in levels) > mean_tol:
        raise AssertionError(f"{label}: {levels} past {tol} levels")
    if any(a.std() < 1.0 for a in got):
        raise AssertionError(f"{label}: a flat image")
    return levels


def _run_counted(fn):
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def _peak(fn):
    """(result, seconds, peak bytes above what was allocated before)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def _dp_http(engine, model, card, info) -> list:
    """(a): data=4 under the in-process server against one device."""
    from sdwebui_tpu_torch.parallel import mesh

    cfg = model.unet_cfg
    b2, b5 = STEPS * launch_plan(cfg, 64), STEPS * ln_plan(cfg, 64)
    body = dict(SD15_BASE, seed=4321, batch_size=DP_DATA)
    results = []
    heads = cfg.heads_for(cfg.model_channels)
    try:
        mesh.set_runtime(mesh.MeshRuntime.create(data=DP_DATA, devices=[card] * DP_DATA))
        with _server(engine) as url, _attention_shapes() as seen:
            dp = _request(url, "txt2img", body, _sd15_check, 512, "4q (a) data=4", keep_all=True)
            _check_launches([dp], [_plan(b1=DP_DATA, b2=DP_DATA * b2,
                                         b5=DP_DATA * b5 + clip_ln_plan(model))])
            _check_shapes(seen, {("flash_attention_packed", (2, s, heads * 40 * m),
                                  (2, s, heads * 40 * m), heads)
                                 for s, m in ((4096, 1), (1024, 2))}
                          | {("flash_attention", (1, 4096, 512), (1, 4096, 512), 1)},
                          "4q (a) data=4")
            seen.clear()
            b3 = _request(url, "txt2img", dict(SD15_BASE, seed=77, batch_size=3), _sd15_check,
                          512, "4q (a) batch 3 falls back")
            _check_launches([b3], [_plan(b1=1, b2=b2, b5=b5 + clip_ln_plan(model))])
            _check_shapes(seen, {("flash_attention_packed", (6, s, heads * 40 * m),
                                  (6, s, heads * 40 * m), heads)
                                 for s, m in ((4096, 1), (1024, 2))}
                          | {("flash_attention", (3, 4096, 512), (3, 4096, 512), 1)},
                          "4q (a) batch 3")
        mesh.set_runtime(mesh.MeshRuntime.create(data=1, devices=[card]))
        with _server(engine) as url:
            one = _request(url, "txt2img", body, _sd15_check, 512, "4q (a) one device",
                           keep_all=True)
            _check_launches([one], [_plan(b1=1, b2=b2, b5=b5 + clip_ln_plan(model))])
            # what each data shard computes: one device's batch-1 request of
            # seed + i
            singles = []
            for i in range(DP_DATA):
                singles.append(_request(url, "txt2img", dict(body, batch_size=1,
                                                             seed=body["seed"] + i),
                                        _sd15_check, 512, f"4q (a) one device seed + {i}"))
                _check_launches(singles[-1:], [_plan(b1=1, b2=b2, b5=b5 + clip_ln_plan(model))])
    finally:
        mesh.set_runtime(None)
    # the yardstick: one device's batch-4 images against its batch-1 ones
    # (bf16 GEMMs over 8 rows against 2)
    yard = [_levels(r["image"], a) for r, a in zip(singles, one["all_images"])]
    log(f"4q (a) one device, batch 4 vs batch 1 of each seed: {yard}")
    info["dp"] = dict(levels=_images_within("4q (a) data=4 vs one device batch 1",
                                            dp["all_images"], [r["image"] for r in singles],
                                            DP_TOL, 0.0),
                      batch4_vs_batch1=yard, seconds=dp["seconds"],
                      one_device_seconds=one["seconds"], batch3_seconds=b3["seconds"],
                      batch1_seconds=[r["seconds"] for r in singles])
    return [dp, b3, one] + singles


def _tp_f32(model, card, info) -> list:
    """(b): model=2 and data=2 × model=2 txt2img at 512² in f32."""
    from sdwebui_tpu_torch.parallel import mesh
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img
    from sdwebui_tpu_torch.utils import devices as dv

    cfg = model.unet_cfg
    b2, b5 = TP_STEPS * launch_plan(cfg, 64), TP_STEPS * ln_plan(cfg, 64)
    clip = clip_ln_plan(model)
    heads = cfg.heads_for(cfg.model_channels)
    results, prev = [], dv.get_policy()

    def params(batch):
        return GenerationParams(**dict(SD15_BASE, seed=2468, batch_size=batch, steps=TP_STEPS,
                                       override_settings={"sdtpu_vae_bf16": False}))

    def images(res):
        return list(res.images[res.index_of_first_image:])

    dv.set_policy(dv.FP32_POLICY)
    try:
        for data, model_axis in ((1, 2), (2, 2)):
            mesh.set_runtime(mesh.MeshRuntime.create(data=1, devices=[card]))
            one, one_s, one_counts = _run_counted(lambda: process_txt2img(model, params(data)))
            _check_launches([dict(launches=one_counts)],
                            [_plan(b1=1, b2=b2, b5=b5 + clip)])
            rt = mesh.MeshRuntime.create(data=data, model=model_axis,
                                         devices=[card] * (data * model_axis))
            mesh.set_runtime(rt)
            label = f"4q (b) data={data} model={model_axis} f32"
            with _attention_shapes() as seen:
                out, secs, counts = _run_counted(lambda: process_txt2img(model.replicate(rt),
                                                                         params(data)))
            n = data * model_axis
            _check_launches([dict(launches=counts)],
                            [_plan(b1=data, b2=n * b2, b5=n * b5 + clip)])
            _check_shapes(seen, {("flash_attention_packed", (2, s, heads // 2 * 40 * m),
                                  (2, s, heads // 2 * 40 * m), heads // 2)
                                 for s, m in ((4096, 1), (1024, 2))}
                          | {("flash_attention", (1, 4096, 512), (1, 4096, 512), 1)}, label)
            log(f"{label}: {secs:.3f} s, one device {one_s:.3f} s ({TP_STEPS} steps)")
            info[f"tp_{data}x{model_axis}"] = dict(
                levels=_images_within(label, images(out), images(one), TP_TOL),
                seconds=secs, one_device_seconds=one_s)
            results += [dict(label=label, launches=counts, seconds=secs),
                        dict(label=label + " one device", launches=one_counts, seconds=one_s)]
    finally:
        dv.set_policy(prev)
        mesh.set_runtime(None)
    return results


def _rows_decode(model, card, info) -> list:
    """(c): a 1024² decode on 4 row shards against the whole decode."""
    from sdwebui_tpu_torch.parallel import mesh
    from sdwebui_tpu_torch.parallel.spatial import decode_spatial

    g = torch.Generator(device=card).manual_seed(31)
    z = torch.randn((1, 4, 128, 128), generator=g, device=card)
    rt = mesh.MeshRuntime.create(data=4, devices=[card] * 4)
    results = []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            zz = z.to(dtype)
            name = str(dtype)[6:]
            with torch.inference_mode():
                model.vae.decode(zz)                     # warm: the convs' algorithms
                decode_spatial(model.vae, zz, rt)
                ref, whole_s, whole_peak = _peak(lambda: model.vae.decode(zz))
                with _attention_shapes() as seen:
                    (got, rows_s, rows_peak), _, counts = _run_counted(
                        lambda: _peak(lambda: decode_spatial(model.vae, zz, rt)))
            _check_launches([dict(launches=counts)], [_plan(b1=4)])
            _check_shapes(seen, {("flash_attention", (1, 4096, 512), (1, 16384, 512), 1)},
                          f"4q (c) rows {name}")
            a, b = (_to_u8(t[0]).numpy() for t in (got, ref))
            lv = _levels(a, b)
            rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
            if dtype == torch.bfloat16:
                with torch.inference_mode():
                    whole_f32 = _to_u8(model.vae.decode(z.float())[0]).numpy()
                yard = _levels(b, whole_f32)
                del whole_f32
            log(f"4q (c) 1024² decode {name}: 4 row shards {rows_s * 1e3:.1f} ms, peak "
                f"{rows_peak / 2 ** 30:.3f} GiB; whole {whole_s * 1e3:.1f} ms, peak "
                f"{whole_peak / 2 ** 30:.3f} GiB; uint8 {lv} (bound {ROWS_TOL[dtype]}), "
                f"max|Δ|/max|ref| {rel:.2e}; the whole decode bf16 vs f32: {yard}")
            tol, mean_tol = ROWS_TOL[dtype]
            if lv["max"] > tol or lv["mean"] > mean_tol or not torch.isfinite(got).all():
                raise AssertionError(f"4q (c) {name}: the row-sharded decode is {lv} levels off")
            info[f"rows_{name}"] = dict(levels=lv, rel_err=rel, whole_bf16_vs_f32=yard,
                                        rows_ms=rows_s * 1e3,
                                        whole_ms=whole_s * 1e3, rows_peak_gib=rows_peak / 2 ** 30,
                                        whole_peak_gib=whole_peak / 2 ** 30)
            results.append(dict(label=f"4q (c) rows {name}", launches=counts, seconds=rows_s))
            del ref, got
    finally:
        mesh.set_runtime(None)
    return results


def _ring(card, info):
    """(d): ring attention on four shards against plain attention, f32."""
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.parallel.sequence import ring_attention, seq_mesh

    g = torch.Generator(device=card).manual_seed(41)
    b, h, s, d = RING_SHAPE
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device=card) for _ in range(3))
    group = seq_mesh(4, [card] * 4)
    ring_attention(q, k, v, group)
    out, ring_s, ring_peak = _peak(lambda: ring_attention(q, k, v, group))
    ref, plain_s, plain_peak = _peak(lambda: fa.flash_attention_plain(
        q.reshape(b * h, s, d), k.reshape(b * h, s, d), v.reshape(b * h, s, d)).reshape(
        RING_SHAPE))
    err = (out - ref).abs()
    ok = bool((err <= 2e-5 + 1e-4 * ref.abs()).all())
    log(f"4q (d) ring attention {RING_SHAPE} f32 on 4 shards: {ring_s * 1e3:.1f} ms, peak "
        f"{ring_peak / 2 ** 30:.3f} GiB; plain {plain_s * 1e3:.1f} ms, peak "
        f"{plain_peak / 2 ** 30:.3f} GiB; max|Δ| {float(err.max()):.2e} (atol 2e-5, rtol 1e-4)")
    if not ok:
        raise AssertionError("4q (d): ring attention disagrees with plain attention")
    info["ring"] = dict(ms=ring_s * 1e3, plain_ms=plain_s * 1e3, max_abs_err=float(err.max()),
                        peak_gib=ring_peak / 2 ** 30, plain_peak_gib=plain_peak / 2 ** 30)


def _train(model, card, info):
    """(e): one (data=2, model=2) step at SD1.5 widths against one device's."""
    from sdwebui_tpu_torch.parallel import mesh
    from sdwebui_tpu_torch.parallel.sharding import gather_state_dict
    from sdwebui_tpu_torch.training.train_step import make_train_step

    g = torch.Generator(device=card).manual_seed(51)
    cfg = model.unet_cfg
    batch = {"x0": torch.randn((2, 4, 32, 32), generator=g, device=card),
             "noise": torch.randn((2, 4, 32, 32), generator=g, device=card),
             "t": torch.randint(0, 1000, (2,), generator=g, device=card),
             "ctx": torch.randn((2, 77, cfg.context_dim), generator=g, device=card)}
    src = {k: v.float() for k, v in model.unet.state_dict().items()}
    out = {}
    for data, model_axis in ((1, 1), (2, 2)):
        rt = mesh.MeshRuntime.create(data=data, model=model_axis,
                                     devices=[card] * (data * model_axis))
        step, shard_batch, prepare = make_train_step(rt, cfg, model.disc)

        def run():
            t0 = time.perf_counter()
            unet = copy.deepcopy(model.unet).float()
            shards, opts = prepare(unet)
            del unet
            torch.cuda.synchronize()
            log(f"4q (e) data={data} model={model_axis}: the f32 copy and prepare "
                f"{time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            shards, opts, loss = step(shards, opts, shard_batch(batch))
            torch.cuda.synchronize()
            row = shards[0]
            named = [dict(s.named_parameters()) for s in row]
            grads = [{k: p.grad for k, p in n.items()} for n in named]
            params = gather_state_dict(row) if model_axis > 1 else row[0].state_dict()
            grads = gather_state_dict(row, grads) if model_axis > 1 else grads[0]
            return (float(loss), {k: v.detach().clone() for k, v in params.items()},
                    {k: v.detach().clone() for k, v in grads.items()}, time.perf_counter() - t0)

        (loss, params, grads, step_s), secs, peak = _peak(run)
        gc.collect()
        torch.cuda.empty_cache()
        out[(data, model_axis)] = (loss, params, grads)
        log(f"4q (e) train step data={data} model={model_axis}: loss {loss:.6f}, step "
            f"{step_s * 1e3:.1f} ms ({secs:.2f} s with the copies), peak {peak / 2 ** 30:.2f} GiB")
        info[f"train_{data}x{model_axis}"] = dict(loss=loss, step_ms=step_s * 1e3,
                                                  seconds=secs, peak_gib=peak / 2 ** 30)
    (l1, p1, g1), (l4, p4, g4) = out[(1, 1)], out[(2, 2)]

    def rel(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in b) / max(
            float(b[k].abs().max()) for k in b)

    loss_rel = abs(l4 - l1) / abs(l1)
    p_rel, g_rel, moved, moved4 = rel(p4, p1), rel(g4, g1), rel(p1, src), rel(p4, src)
    upd = _update_rel(src, p4, p1, g1)
    log(f"4q (e) (2, 2) vs one device: loss {loss_rel:.2e} (bound {TRAIN_LOSS_TOL}), params "
        f"{p_rel:.2e} ({TRAIN_PARAM_TOL}), grads {g_rel:.2e} ({TRAIN_GRAD_TOL}); the update "
        f"{upd['rel']:.2e} of max|Δp_one| {upd['max_step']:.3e} ({TRAIN_UPDATE_TOL}) over the "
        f"elements above rounding level, {upd['masked']} of {upd['total']} masked (|g| <= "
        f"{upd['floor']:.3e}; the most in {upd['masked_in']}); the step moved the params by "
        f"{moved4:.3e} of max|p| against one device's {moved:.3e}")
    if loss_rel > TRAIN_LOSS_TOL or p_rel > TRAIN_PARAM_TOL or g_rel > TRAIN_GRAD_TOL \
            or upd["rel"] > TRAIN_UPDATE_TOL or not moved > 0 \
            or abs(moved4 / moved - 1) > TRAIN_MOVED_TOL:
        raise AssertionError("4q (e): the sharded train step disagrees with one device's")
    info["train_rel"] = dict(loss=loss_rel, params=p_rel, grads=g_rel, moved=moved,
                             moved_sharded=moved4, update=upd)


def _update_rel(src: dict, got: dict, one: dict, one_grads: dict) -> dict:
    """The sharded update against the one-device update, element for
    element: max|(got − src) − (one − src)| / max|one − src| over the
    elements whose one-device gradient is above TRAIN_ROUNDING of the
    largest |g|, with what was masked."""
    peak = max(float(g.abs().max()) for g in one_grads.values())
    floor = TRAIN_ROUNDING * peak
    num, step, masked, total, per_key = 0.0, 0.0, 0, 0, {}
    for k, g in one_grads.items():
        mask = g.abs() <= floor
        n = int(mask.sum())
        masked, total = masked + n, total + mask.numel()
        if n:
            per_key[k] = n
        one_step = one[k] - src[k]
        diff = ((got[k] - src[k]) - one_step).abs()[~mask]
        if diff.numel():
            num = max(num, float(diff.max()))
        step = max(step, float(one_step.abs().max()))
    top = sorted(per_key.items(), key=lambda kv: -kv[1])[:4]
    return dict(rel=num / step, max_step=step, masked=masked, total=total, floor=floor,
                masked_in=[f"{k} {n}/{one_grads[k].numel()}" for k, n in top])


# 4s: the text JAX draws on grids and cards
TEXT_STEPS = SAMPLER_STEPS
#: Prompt S/R values with kerned pairs (WA, AV, VY, TO, OY in DejaVuSans)
TEXT_SR = "astronaut, WAVY TOY"
LEGEND_REPEATS = 5


def phase_text(engine, model):
    """4s: the text on grids and cards over the phase-3 server: (a) an X/Y/Z
    request (Prompt S/R over two values × Seed, draw_legend on) whose grid
    has a legend gutter above and to the left, not blank, and equal to the
    legend the port draws on the response's own cells, and unequal to a
    planted copy drawn with kerning removed; (b) a prompt-matrix request
    with one variable part, its legend's struck-through part; (c) the
    embedding card of a trained embedding: its name and step drawn; the
    host ms to draw a legend and a card.  Each request launches B1, B2
    and B5 as its cells plan.  Returns (results, info)."""
    from sdwebui_tpu_torch.training.textual_inversion import card_image
    from sdwebui_tpu_torch.utils import grid_annotations, text_raster
    from sdwebui_tpu_torch.utils.png import decode_png

    cfg = model.unet_cfg
    size = SD15_BASE["width"]
    lp, ln, clip = launch_plan(cfg, size // 8), ln_plan(cfg, size // 8), clip_ln_plan(model)
    base = dict(SD15_BASE, seed=4242, steps=TEXT_STEPS)
    results, info = [], {}

    def request(url, body, cells, label):
        reset_counts()
        t0 = time.perf_counter()
        res = _post(f"{url}/txt2img", body)
        dt = time.perf_counter() - t0
        counts = read_counts()
        plan = _plan(b1=cells, b2=cells * TEXT_STEPS * lp, b5=cells * (TEXT_STEPS * ln + clip))
        if counts != plan:
            raise AssertionError(f"4s {label}: launches {counts} != planned {plan}")
        imgs = [decode_png(base64.b64decode(b))[0] for b in res["images"]]
        log(f"4s {label}: {dt:.3f} s, images {[im.shape for im in imgs]}, launches {counts}")
        results.append(dict(route="txt2img", label=f"4s {label}", batch=len(imgs),
                            seed=body["seed"], seconds=dt, launches=counts))
        return imgs

    with _server(engine) as url:
        # (a) X/Y/Z with its legend
        xs = [v.strip() for v in TEXT_SR.split(",")]
        imgs = request(url, dict(base, script_name="X/Y/Z plot", script_args=[
            "Prompt S/R", TEXT_SR, "Seed", "1-2", "Nothing", "", True]), 4, "X/Y/Z legend")
        grid, cells = imgs[0], imgs[1:]
        gutter_left = size * 3 // 4
        top = grid.shape[0] - 2 * size
        if grid.shape[1] != 2 * size + gutter_left or top <= 0:
            raise AssertionError(f"4s X/Y/Z grid {grid.shape}: no legend gutters")
        bare = torch.cat([torch.cat([torch.from_numpy(c) for c in cells[r * 2:r * 2 + 2]], 1)
                          for r in (0, 1)]).numpy()
        hor = [[grid_annotations.GridAnnotation(f"Prompt S/R: {v}")] for v in xs]
        ver = [[grid_annotations.GridAnnotation(f"Seed: {v}")] for v in (1, 2)]
        t0 = time.perf_counter()
        redrawn = grid_annotations.draw_grid_annotations(bare, size, size, hor, ver)
        first_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(LEGEND_REPEATS):
            t0 = time.perf_counter()
            grid_annotations.draw_grid_annotations(bare, size, size, hor, ver)
            times.append((time.perf_counter() - t0) * 1e3)
        ink = int((grid[:top] != 255).any(-1).sum()
                  + (grid[top:, :gutter_left] != 255).any(-1).sum())
        real_font = grid_annotations.get_font

        def unkerned(fontsize):
            face = real_font(fontsize)
            return text_raster.Face(face.path, face.size, kerning=False)

        grid_annotations.get_font = unkerned
        try:
            planted = grid_annotations.draw_grid_annotations(bare, size, size, hor, ver)
        finally:
            grid_annotations.get_font = real_font
        kern_px = int((planted != redrawn).any(-1).sum())
        log(f"4s X/Y/Z legend: {ink} ink pixels in the gutters; the port's redraw on the "
            f"response's cells differs from the response in "
            f"{int((redrawn != grid).any(-1).sum())} pixels, the planted copy without kerning "
            f"in {kern_px}; a legend {statistics.median(times):.2f} ms on the host "
            f"(first {first_ms:.2f} ms)")
        if not ink or redrawn.shape != grid.shape or (redrawn != grid).any() or not kern_px:
            raise AssertionError("4s X/Y/Z legend: blank, unlike the port's own redraw, or "
                                 "the same without kerning")
        info["legend_ms"] = statistics.median(times)
        info["legend_first_ms"] = first_ms
        info["legend_ink_px"] = ink
        info["unkerned_px"] = kern_px
        # (b) the prompt matrix
        imgs = request(url, dict(base, seed=4243, prompt=SD15_BASE["prompt"] + " | at night",
                                 script_name="Prompt matrix", script_args=[False]), 2,
                       "prompt matrix")
        strike = int((imgs[0][:imgs[0].shape[0] - size] == (153, 153, 153)).all(-1).sum())
        log(f"4s prompt matrix: grid {imgs[0].shape}, {strike} strike-line pixels")
        if imgs[0].shape[:2] == (size, 2 * size) or not strike:
            raise AssertionError("4s prompt matrix: no legend or no struck-through part")
        info["matrix_strike_px"] = strike
    # (c) the embedding card
    vec = torch.ones((2, 768)).numpy()
    card_image("chip-card", vec, 500)
    t0 = time.perf_counter()
    card = card_image("chip-card", vec, 500)
    info["card_ms"] = (time.perf_counter() - t0) * 1e3
    left = (card.shape[1] - 512) // 2
    text_px = int((card[228:242, left + 24:left + 120] != (32, 38, 48)).any(-1).sum())
    log(f"4s embedding card: {text_px} ink pixels of the name, {info['card_ms']:.2f} ms")
    if not text_px:
        raise AssertionError("4s embedding card: no name drawn")
    info["card_ink_px"] = text_px
    return results, info


# --------------------------------------------------------------------------
# 4t: the rarer image formats
# --------------------------------------------------------------------------

#: the writers 4t (d) runs on a response, through save_image_with_geninfo
RARE_WRITERS = ("qoi", "ppm", "sgi", "pcx", "dds", "im", "ico", "icns")


def phase_rare_formats(engine, model, phase3: dict, directory: str):
    """4t: (a) the numpy writers' files of every rarer format at 512², and
    the committed files libzstd and libtiff wrote, each decoded equal to its
    pixels, with each decoder's host ms; (b) img2img
    from a TGA (RLE) and a PSD (PackBits) within REPEAT_TOL of the same
    request from the PNG; (c) txt2img saving a tga; (d) the other writers
    on that response.  Returns (results, info)."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils import images as images_util, saving
    from sdwebui_tpu_torch.utils.image_io import decode_image
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    files_mod = _image_files_helper()
    sample = phase3["image"]
    info: dict = {}
    t0 = time.perf_counter()
    files = files_mod.rare_files(sample)
    info["files_s"] = time.perf_counter() - t0
    files.update(files_mod.library_files())
    decode_ms = {}
    for name, (data, want) in files.items():
        t = time.perf_counter()
        got = decode_image(data)[0]
        decode_ms[name] = (time.perf_counter() - t) * 1e3
        if got.shape != want.shape or not (got == want).all():
            bad = int((got != want).any(axis=-1).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"4t (a): {name} decodes to {got.shape}, {bad} pixels off its "
                                 f"writer's {want.shape}")
    info["decode_ms_512"] = decode_ms
    info["bytes_512"] = {name: len(data) for name, (data, _) in files.items()}
    page = files_mod.scanned_page()
    g4 = files_mod.tiff_file(page, "g4", depth=1, photometric=0)
    t = time.perf_counter()
    got = decode_image(g4)[0]
    info["g4_page_1728x2200_ms"] = (time.perf_counter() - t) * 1e3
    if not (got[:, :, 0] == (1 - page) * 255).all():
        raise AssertionError("4t (a): the Group 4 page does not decode to its writer's bits")
    log(f"4t (a) {len(files)} files (the numpy writers' in {info['files_s']:.2f} s); decode "
        "host ms: "
        + json.dumps({k: round(v, 2) for k, v in decode_ms.items()})
        + f"; a 1728×2200 Group 4 page ({len(g4)} bytes) "
        f"{info['g4_page_1728x2200_ms']:.2f} ms")

    outdir = os.path.join(directory, "outputs")
    prev_outdir, engine.outdir = engine.outdir, outdir
    txt_plan = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                     b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    i2i_plan = _plan(b1=2, b2=(t_enc + 1) * launch_plan(model.unet_cfg, 64),
                     b5=(t_enc + 1) * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    results = []

    def generate(url, route, body, label, plan):
        reset_counts()
        t = time.perf_counter()
        res = _post(f"{url}/{route}", body)
        dt = time.perf_counter() - t
        launches = read_counts()
        log(f"4t {label}: {dt:.3f} s, launches {launches}")
        if launches != plan:
            raise AssertionError(f"4t {label}: launches {launches} != planned {plan}")
        images = [decode_png(base64.b64decode(b))[0] for b in res["images"]]
        if any(img.std() < 1.0 for img in images):
            raise AssertionError(f"4t {label}: a flat image")
        results.append(dict(route=route, label=f"4t {label}", batch=1, seed=body["seed"],
                            seconds=dt, launches=launches))
        return res, images

    try:
        with _server(engine) as url:
            # (b) img2img from a TGA and a PSD against the PNG of the same pixels
            i2i = dict(SD15_BASE, denoising_strength=DENOISE, seed=97531)
            inits = {"png": encode_png(sample), "tga_rle": files_mod.tga_file(sample, rle=True),
                     "psd_packbits": files_mod.psd_file(sample.transpose(2, 0, 1), 3, True)}
            outs = {}
            for name, data in inits.items():
                _, images = generate(url, "img2img", dict(i2i, init_images=[
                    base64.b64encode(data).decode()]), f"img2img from the {name}", i2i_plan)
                outs[name] = images[0]
            deltas = {name: int(abs(outs[name].astype(int) - outs["png"].astype(int)).max())
                      for name in ("tga_rle", "psd_packbits")}
            log(f"4t (b) max|Δ| against the PNG of the same pixels: {json.dumps(deltas)} "
                f"(bound {REPEAT_TOL})")
            if max(deltas.values()) > REPEAT_TOL:
                raise AssertionError(f"4t (b): img2img from a format differs from its PNG: "
                                     f"{deltas}")
            info["img2img_max_delta"] = deltas
            # (c) txt2img saving a tga
            before = set(_saved_files(outdir)) if os.path.isdir(outdir) else set()
            _, images = generate(url, "txt2img", dict(
                SD15_BASE, seed=8642, save_images=True,
                override_settings=dict(samples_format="tga")), "txt2img saving tga", txt_plan)
            saving.flush_saves()
            written = sorted(set(_saved_files(outdir)) - before)
            if len(written) != 1 or not written[0].endswith(".tga"):
                raise AssertionError(f"4t (c): wrote {written}")
            shown = images[0]
            got = decode_image(open(os.path.join(outdir, written[0]), "rb").read())[0]
            if got.shape != shown.shape or not (got == shown).all():
                raise AssertionError(f"4t (c): {written[0]} does not decode to the response")
            info["saved_tga"] = written[0]
            log(f"4t (c) {written[0]} decodes to the response's pixels")
    finally:
        engine.outdir = prev_outdir

    # (d) the other writers on the response
    write_ms = {}
    for ext in RARE_WRITERS:
        path = os.path.join(directory, f"response.{ext}")
        t = time.perf_counter()
        saving.save_image_with_geninfo(shown, None, path)
        write_ms[ext] = (time.perf_counter() - t) * 1e3
        got = decode_image(open(path, "rb").read())[0]
        want = {"ico": lambda: images_util.resize(shown, (256, 256), "lanczos"),
                "icns": lambda: images_util.resize(shown, (1024, 1024), "bicubic")}.get(
                    ext, lambda: shown)()
        if got.shape != want.shape or not (got == want).all():
            raise AssertionError(f"4t (d): the {ext} file decodes to {got.shape}, not the "
                                 f"response's {want.shape}")
    info["write_ms_512"] = write_ms
    log("4t (d) writer host ms: " + json.dumps({k: round(v, 2) for k, v in write_ms.items()}))
    info["f32_encodes_512"] = sum(r["route"] == "img2img" for r in results)
    info["decodes_512"] = sum(r["launches"]["flash_attention"] for r in results) \
        - info["f32_encodes_512"]
    return results, info


# --------------------------------------------------------------------------
# 4u: JPEG 2000
# --------------------------------------------------------------------------

#: the committed JPEG 2000 files and Pillow's pixels of each
J2K_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "jpeg2000")
#: the size of txt2img (c)'s second request, batch 2: its samples and its j2k grid
J2K_SAVE_SIDE = 64


def _read_npz(path: str) -> dict:
    """The arrays of an .npz written by numpy.savez_compressed, read with
    the stdlib: {name: (shape, raw bytes)} (C order, little-endian)."""
    import ast
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as z:
        for member in z.namelist():
            raw = z.read(member)
            major = raw[6]
            hlen = struct.unpack_from("<H" if major == 1 else "<I", raw, 8)[0]
            start = 10 if major == 1 else 12
            header = ast.literal_eval(raw[start:start + hlen].decode("latin1"))
            out[member[:-4]] = (tuple(header["shape"]), raw[start + hlen:])
    return out


def phase_jpeg2000(engine, model, phase3: dict, directory: str):
    """4u: (a) every committed JPEG 2000 fixture decoded equal to Pillow's
    pixels (the two 512² files to their SHA-256; sYCC within 1 level), each
    decode's host ms; (c) phase 3's request again with samples_format jp2,
    its image saved by the writer as a lossless 512² .jp2 (the encode's host
    ms, timed around the writer's encoder), and txt2img at J2K_SAVE_SIDE²,
    batch 2, with samples_format jp2 and grid_format j2k, those three files
    decoded equal to the response's images; (b) img2img from the 512² .jp2
    within REPEAT_TOL of the same request from the PNG of its pixels,
    launches as 4t plans them; (d) a PDF of an RGBA image of the batch-2
    response, its JPXDecode stream decoded to its pixels.  Returns (results,
    info)."""
    import hashlib
    import re

    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils import saving
    from sdwebui_tpu_torch.utils.jpeg2000 import decode_jpeg2000
    from sdwebui_tpu_torch.utils.pdf import encode_pdf
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    info: dict = {}
    t_phase = time.perf_counter()
    # (a) the fixtures
    decode_ms = {}
    for name in sorted(os.listdir(J2K_FIXTURES)):
        if name.endswith(".npz"):
            continue
        data = open(os.path.join(J2K_FIXTURES, name), "rb").read()
        ref = _read_npz(os.path.join(J2K_FIXTURES, os.path.splitext(name)[0] + ".npz"))
        t = time.perf_counter()
        got = decode_jpeg2000(data)[0]
        decode_ms[name] = (time.perf_counter() - t) * 1e3
        if "pixels" in ref:
            shape, raw = ref["pixels"]
            want = torch.frombuffer(bytearray(raw), dtype=torch.uint8).reshape(shape)
            bound = 1 if "sycc" in name else 0
            if tuple(got.shape) != shape or (torch.from_numpy(got).int()
                                             - want.int()).abs().max().item() > bound:
                raise AssertionError(f"4u (a): {name} does not decode to Pillow's pixels")
        elif hashlib.sha256(got.tobytes()).digest() != ref["sha256"][1] or \
                list(got.shape) != list(torch.frombuffer(bytearray(ref["shape"][1]),
                                                         dtype=torch.int64).tolist()):
            raise AssertionError(f"4u (a): {name} does not decode to Pillow's pixels")
    info["decode_ms"] = decode_ms
    log("4u (a) " + f"{len(decode_ms)} fixtures decoded to Pillow's pixels; host ms: "
        + json.dumps({k: round(v, 1) for k, v in decode_ms.items()}))

    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    t2i_plan = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                     b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    i2i_plan = _plan(b1=2, b2=(t_enc + 1) * launch_plan(model.unet_cfg, 64),
                     b5=(t_enc + 1) * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    results = []
    outdir = os.path.join(directory, "outputs")
    prev_outdir, engine.outdir = engine.outdir, outdir
    encoder = saving.encode_jpeg2000
    encodes = []

    def timed_encoder(image, kind="jp2", **settings):
        t0 = time.perf_counter()
        out = encoder(image, kind, **settings)
        encodes.append((tuple(image.shape), kind, (time.perf_counter() - t0) * 1e3))
        return out

    saving.encode_jpeg2000 = timed_encoder       # the writer's encoder, timed
    try:
        with _server(engine) as url:
            def generate(route, body, label, plan):
                reset_counts()
                t = time.perf_counter()
                res = _post(f"{url}/{route}", body)
                dt = time.perf_counter() - t
                launches = read_counts()
                log(f"4u {label}: {dt:.3f} s, launches {launches}")
                if launches != plan:
                    raise AssertionError(f"4u {label}: launches {launches} != planned {plan}")
                results.append(dict(route=route, label=f"4u {label}", batch=body["batch_size"]
                                    if "batch_size" in body else 1, seed=body["seed"],
                                    seconds=dt, launches=launches))
                saving.flush_saves()
                return res, [decode_png(base64.b64decode(b))[0] for b in res["images"]]

            # (c) phase 3's request saving its 512² image as .jp2
            body = dict(SD15_BASE, seed=phase3["seed"], batch_size=1, save_images=True,
                        override_settings=dict(samples_format="jp2"))
            before = set(_saved_files(outdir)) if os.path.isdir(outdir) else set()
            _, shown = generate("txt2img", body, "(c) phase 3's request saved as .jp2", t2i_plan)
            written = sorted(set(_saved_files(outdir)) - before)
            if [os.path.splitext(w)[1] for w in written] != [".jp2"] or len(encodes) != 1 \
                    or encodes[0][0] != shown[0].shape:
                raise AssertionError(f"4u (c): wrote {written}, encodes {encodes}")
            jp2 = open(os.path.join(outdir, written[0]), "rb").read()
            info["encode_512_ms"] = encodes[0][2]
            log(f"4u (c) the writer saved the 512² image as {written[0]}: {len(jp2)} bytes, "
                f"encode {info['encode_512_ms']:.1f} ms (host)")
            # (b) img2img from that .jp2 and from the PNG of its pixels
            i2i = dict(SD15_BASE, denoising_strength=DENOISE, seed=97531)
            outs = {}
            for name, data in (("png", encode_png(shown[0])), ("jp2", jp2)):
                _, images = generate("img2img", dict(i2i, init_images=[
                    base64.b64encode(data).decode()]), f"(b) img2img from the {name}", i2i_plan)
                outs[name] = images[0]
                if outs[name].std() < 1.0:
                    raise AssertionError(f"4u (b): a flat image from the {name}")
            delta = int(abs(outs["jp2"].astype(int) - outs["png"].astype(int)).max())
            info["img2img_max_delta"] = delta
            log(f"4u (b) max|Δ| against the PNG of the same pixels: {delta} "
                f"(bound {REPEAT_TOL})")
            if delta > REPEAT_TOL:
                raise AssertionError(f"4u (b): img2img from the .jp2 differs from its PNG: {delta}")
            # (c) samples as jp2 and the grid as j2k
            body = dict(SD15_BASE, seed=8642, width=J2K_SAVE_SIDE, height=J2K_SAVE_SIDE,
                        batch_size=2, save_images=True,
                        override_settings=dict(samples_format="jp2", grid_format="j2k"))
            before = set(_saved_files(outdir))
            reset_counts()
            res = _post(f"{url}/txt2img", body)
            saving.flush_saves()
            log(f"4u (c) txt2img {J2K_SAVE_SIDE}² batch 2 saving jp2 samples and a j2k grid, "
                f"launches {read_counts()}")
    finally:
        engine.outdir = prev_outdir
        saving.encode_jpeg2000 = encoder
    shown = [decode_png(base64.b64decode(b))[0] for b in res["images"]]
    written = sorted(set(_saved_files(outdir)) - before)
    if sorted(os.path.splitext(w)[1] for w in written) != [".j2k", ".jp2", ".jp2"]:
        raise AssertionError(f"4u (c): wrote {written}")
    for name in written:
        got = decode_jpeg2000(open(os.path.join(outdir, name), "rb").read())[0]
        if not any(got.shape == s.shape and (got == s).all() for s in shown):
            raise AssertionError(f"4u (c): {name} does not decode to an image of the response")
    log(f"4u (c) {written} decode to the response's images")
    # (d) a PDF of an RGBA image: JPXDecode with SMaskInData
    last = torch.from_numpy(shown[-1])
    rgba = torch.cat([last, last[:, :, 1:2]], dim=2).numpy()
    pdf = encode_pdf(rgba, 80, os.path.join(directory, "rgba.pdf"))
    m = re.search(rb"/Filter /JPXDecode\n/SMaskInData 1\n/Length (\d+)\n>>stream\n", pdf)
    if m is None:
        raise AssertionError("4u (d): no JPXDecode image with SMaskInData in the PDF")
    stream = pdf[m.end():m.end() + int(m.group(1))]
    got = decode_jpeg2000(stream)[0]
    if got.shape != rgba.shape or not (got == rgba).all():
        raise AssertionError("4u (d): the PDF's JPX stream does not decode to its RGBA image")
    log(f"4u (d) a PDF of the RGBA {J2K_SAVE_SIDE}² image ({len(pdf)} bytes): its JPX stream "
        f"decodes to its pixels")
    info["decodes_512"] = sum(r["launches"]["flash_attention"] for r in results) \
        - sum(r["route"] == "img2img" for r in results)
    info["f32_encodes_512"] = sum(r["route"] == "img2img" for r in results)
    info["phase_s"] = time.perf_counter() - t_phase
    return results, info


def phase_parallel(engine, model, device):
    """4q: the parallel runtime on meshes that name the card several times:
    (a) data=4 under the in-process server, batch 4, image i within
    DP_TOL levels of one device's batch-1 request of seed + i, B1 4, B2
    800, B5 3866 (each shard's UNet at (2, S, 8·d)), a batch-3 request on
    the unsharded path; (b) model=2 (batch 1) and data=2 × model=2 (batch
    2) txt2img at 512², TP_STEPS steps, in f32 within TP_TOL of one device,
    B2 per model shard at (2, 4096, 4·40) and (2, 1024, 4·80); (c) a 1024²
    decode of a seeded latent on 4 row shards in bf16 and f32 against the
    whole decode, B1 4 at (1, 4096, 16384, 512); (d) ring attention at (1,
    8, 16384, 64) on 4 shards against plain attention; (e) one (data=2,
    model=2) training step at SD1.5 widths, 256², batch 2, f32 against one
    device's, its update element for element.  Returns (results, info)."""
    card = torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)
    info = {}
    results = _dp_http(engine, model, card, info)
    results += _tp_f32(model, card, info)
    results += _rows_decode(model, card, info)
    _ring(card, info)
    gc.collect()
    torch.cuda.empty_cache()
    _train(model, card, info)
    gc.collect()
    torch.cuda.empty_cache()
    return results, info


#: the argument that makes this script the second process (see main)
SECOND = "--second-process"
#: what a request's result keeps in the report (and in the second process's JSON)
_UNREPORTED = ("image", "png_b64", "infotext", "extras", "all_images")


def _reported(results: list) -> list:
    return [{k: v for k, v in r.items() if k not in _UNREPORTED} for r in results]


def _setup():
    """What each process sets before its first phase; the card."""
    from sdwebui_tpu_torch.utils.options import opts

    # the library calls and plain versions of phase 1 in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the persistent cond cache (on by default) would skip the CLIP encode of
    # every repeated prompt; the phases' plans count one encode a request,
    # and 4k turns the cache on for its own requests
    opts.data["persistent_cond_cache"] = False
    return torch.device("cuda")


def _marker():
    """(mark, seconds): mark(phase) logs the seconds since the previous
    mark under `phase` and keeps them in `seconds`."""
    seconds = {}
    t = {"start": time.perf_counter()}
    t["last"] = t["start"]

    def mark(phase: str):
        now = time.perf_counter()
        seconds[phase] = now - t["last"]
        log(f"phase {phase}: {now - t['last']:.1f} s ({now - t['start']:.1f} s in all)")
        t["last"] = now
    return mark, seconds


def _check_no_jax():
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdwebui_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX or the JAX package: {leaked[:5]}")


def _start_second(directory: str):
    """Start the second process (this script with SECOND); its output goes
    to a file in `directory`, its result to another."""
    log_path, out_path = (os.path.join(directory, n) for n in ("second.log", "second.json"))
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), SECOND, out_path],
                                stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                                env=dict(os.environ, PYTHONUNBUFFERED="1"))
    log(f"started the second process (pid {proc.pid}): phases 3 again, 4m, 4n, 4o, 4q, 5, "
        "6, 6b, 6c, 7, 4k(b, f) and 4j")
    return proc, log_path, out_path


def _join_second(second) -> dict:
    """Wait for the second process, copy its log to ours; its result, or
    an AssertionError naming the end of its log."""
    proc, log_path, out_path = second
    t0 = time.perf_counter()
    rc = proc.wait()
    log(f"the second process ended with {rc} after {time.perf_counter() - t0:.1f} s of waiting")
    with open(log_path) as f:
        text = f.read()
    log("---- the second process's log ----")
    sys.stdout.write(text)
    log("---- end of the second process's log ----")
    if rc != 0:
        raise AssertionError(f"the second process exited {rc}:\n"
                             + "\n".join(text.splitlines()[-40:]))
    with open(out_path) as f:
        return json.load(f)


def _exit_with_parent():
    """End this (second) process when the first one is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(2)
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def second_main(out_path: str) -> int:
    """The second process: phase 3 again on a server of its own, then 4m,
    4n, 4o and 4q on it, and SDXL (5, 6, 6b, 6c, 7, 4k(b, f)) and the
    families of 4j, while the first process runs 3, 4s–4u and 4–4l.  What
    the first process reports of these phases goes to `out_path` as JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    _exit_with_parent()
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.server.app import Engine, random_models

    device = _setup()
    mark, phase_s = _marker()
    model = create_random_sd15(seed=0, device=device)
    engine = Engine(model=model, device=device)
    results = phase_serve(engine, model)
    mark("3 config 1, again in the second process")
    script_results, script_info = phase_scripts(engine, model, results[0], device)
    mark("4m scripts")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_saving_") as save_dir:
        save_results, save_info = phase_saving(engine, model, results[0], save_dir)
    mark("4n saving and JPEG")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as formats_dir:
        format_results, format_info = phase_formats(engine, model, results[0], formats_dir)
    mark("4o image formats")
    par_results, par_info = phase_parallel(engine, model, device)
    mark("4q parallel")
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base, extra = random_models("sdxl", device)   # what `--model sdxl` serves
    (refiner,) = extra.values()
    engine = Engine(model=base, device=device, extra_models=extra)
    torch.cuda.synchronize()
    log(f"random SDXL base + refiner on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    sdxl_unet = phase_sdxl_unet(base, refiner, device)
    mark("5 SDXL UNet and VAE")
    sdxl_results, s_idx = phase_sdxl_serve(engine, base, refiner)
    mark("6 config 5")
    sdxl_hr_result, sdxl_hr_info = phase_sdxl_hires(engine, base, refiner)
    mark("6b SDXL hires")
    sdxl_i2i_results, sdxl_i2i_info = phase_sdxl_img2img(engine, base, sdxl_results[0], device)
    mark("6c SDXL img2img")
    profile = phase_profile(engine, sdxl_request(1234, refiner.title), "SDXL")
    mark("7 SDXL profile")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_sdxl_") as opt4k_dir:
        opt4k_xl_results, opt4k_xl_info = phase_options_sdxl(engine, base, opt4k_dir, device)
    mark("4k(b, f) fp8 storage and a pruned SDXL file")
    del base, refiner, extra, engine
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_families_") as family_dir:
        family_results, family_info = phase_families(family_dir, device)
    mark("4j SD3, unclip and AltDiffusion")
    _check_no_jax()
    family_info["b1_calls"] = [[*row, n] for row, n in family_info["b1_calls"].items()]
    with open(out_path, "w") as f:
        json.dump(dict(
            phase_s=phase_s, serve=_reported(results),
            scripts=[_reported(script_results), script_info],
            saving=[_reported(save_results), save_info],
            formats=[_reported(format_results), format_info],
            parallel=[_reported(par_results), par_info],
            sdxl_unet=sdxl_unet, sdxl=[_reported(sdxl_results), s_idx],
            sdxl_hires=[_reported([sdxl_hr_result]), sdxl_hr_info],
            sdxl_img2img=[_reported(sdxl_i2i_results), sdxl_i2i_info],
            sdxl_profile=profile, options_sdxl=[_reported(opt4k_xl_results), opt4k_xl_info],
            families=[_reported(family_results), family_info]), f)
    return 0


def main() -> int:
    """The first process: phases 0–2 alone, then 3, 4s–4u and 4–4l beside
    the second process (second_main), then 4p alone, then the report."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.models.esrgan import register_esrgan_dir
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.postprocessing.upscalers import unregister_upscaler
    from sdwebui_tpu_torch.server.app import Engine

    device = _setup()
    t_start = time.perf_counter()
    mark, phase_s = _marker()
    smi = phase_env()
    mark("0 build")
    rows = phase_kernel(device)
    mark("1 kernels")
    t0 = time.perf_counter()
    model = create_random_sd15(seed=0, device=device)
    torch.cuda.synchronize()
    log(f"random SD1.5 on the card in {time.perf_counter() - t0:.2f} s")
    tower = random_tower(model.unet_cfg, 11, device)
    unet = phase_unet(model, device, tower)
    mark("2 SD1.5 UNet")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_second_") as second_dir:
        second = _start_second(second_dir)

        def mark_beside(phase: str):
            """mark, and end the run here if the second process failed."""
            mark(phase)
            if second[0].poll() not in (None, 0):
                _join_second(second)     # logs its output and raises
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_upscalers_") as upscaler_dir:
                t0 = time.perf_counter()
                upscaler_paths = write_upscaler_files(upscaler_dir)
                log(f"wrote the upscaler files {sorted(upscaler_paths)} in "
                    f"{time.perf_counter() - t0:.2f} s")
                # the process's upscaler registry, as the server's
                # --esrgan-models-path fills it; the files and their nets leave
                # it with the directory
                upscaler_names = register_esrgan_dir((upscaler_dir,), device=device)
                try:
                    engine = Engine(model=model, device=device)
                    results = phase_serve(engine, model)
                    mark_beside("3 config 1")
                    i2i_results, i2i_calls = phase_img2img(engine, model, results[0]["png_b64"])
                    mark_beside("4 config 2")
                    with tempfile.TemporaryDirectory(prefix="chip_smoke_img2img_") as opt_dir:
                        opt_results, opt_info = phase_img2img_options(engine, model, results[0],
                                                                      opt_dir, device)
                    mark_beside("4g img2img options")
                    hr_results, hr_info = phase_hires(engine, model, upscaler_paths)
                    b1_calls = hr_info.pop("b1_calls")     # {(phase-1 row, dtype): calls}
                    hr_info["profile"] = phase_profile(engine, hires_request(2024), "config 3",
                                                       wall=hr_info["latent_wall_s"])
                    mark_beside("4c config 3")
                    extras = phase_extras(engine, [results[0]["png_b64"], results[1]["png_b64"]],
                                          upscaler_paths)
                    mark_beside("4d extras")
                finally:
                    for name in upscaler_names:
                        unregister_upscaler(name)
            text_results, text_info = phase_text(engine, model)
            mark_beside("4s text")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_rare_") as rare_dir:
                rare_results, rare_info = phase_rare_formats(engine, model, results[0], rare_dir)
            mark_beside("4t rarer formats")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_j2k_") as j2k_dir:
                j2k_results, j2k_info = phase_jpeg2000(engine, model, results[0], j2k_dir)
            mark_beside("4u JPEG 2000")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_networks_") as network_dir:
                c4_results, c4_info = phase_config4(engine, model, results[0], network_dir, tower)
            mark_beside("4e config 4")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as hybrid_dir:
                hy_results, hy_info = phase_hybrid(engine, model, results[0], hybrid_dir, device,
                                                   tower)
            del tower
            gc.collect()
            torch.cuda.empty_cache()
            mark_beside("4f hybrids")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_faces_") as face_dir:
                face_results, face_info = phase_faces(engine, model, results, face_dir, device)
            mark_beside("4h job control and faces")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as zoo_root:
                zoo_results, zoo_info = phase_zoo(engine, model, results, zoo_root, device)
            mark_beside("4i upscaler zoo")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
                ckpt_engine, ckpt_results, ckpt_info = phase_checkpoint(model, device, results[0],
                                                                        ckpt_dir)
            mark_beside("4a checkpoints")
            sampler_results = phase_samplers(ckpt_engine)
            del ckpt_engine
            mark_beside("4b samplers")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as opt4k_dir:
                opt4k_results, opt4k_info = phase_options(engine, model, opt4k_dir, device)
            mark_beside("4k(a, c, d, e) options and openpose")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_training_") as train_dir:
                train_results, train_info = phase_training(engine, model, results, train_dir,
                                                           device)
            mark_beside("4l training and interrogation")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            other = _join_second(second)
        except BaseException:
            if second[0].poll() is None:
                second[0].kill()
                second[0].wait()
                with open(second[1]) as f:
                    tail = f.read().splitlines()[-40:]
                log("\n".join(["---- the end of the second process's log, stopped ----",
                                *tail]))
            raise
    mark("the second process joined")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ui_") as ui_dir:
        ui_results, ui_info = phase_ui(model, device, results[0], ui_dir)
    mark("4p page and merger")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the first phase to the report")
    _check_no_jax()

    script_results, script_info = other["scripts"]
    save_results, save_info = other["saving"]
    format_results, format_info = other["formats"]
    par_results, par_info = other["parallel"]
    sdxl_results, s_idx = other["sdxl"]
    sdxl_hr_results, sdxl_hr_info = other["sdxl_hires"]
    sdxl_i2i_results, sdxl_i2i_info = other["sdxl_img2img"]
    opt4k_xl_results, opt4k_info["sdxl"] = other["options_sdxl"]
    family_results, family_info = other["families"]
    phase_s.update({f"second process: {k}": v for k, v in other["phase_s"].items()})
    requests = (_reported(results + i2i_results + opt_results + hr_results + c4_results
                          + hy_results + face_results + zoo_results + ckpt_results
                          + sampler_results + opt4k_results + train_results + ui_results
                          + text_results + rare_results + j2k_results)
                + other["serve"] + script_results + save_results + format_results
                + par_results + sdxl_results + opt4k_xl_results + sdxl_hr_results
                + sdxl_i2i_results + family_results)
    log(json.dumps({"card": smi, "kernel_shapes": rows, "unet_step": unet,
                    "sdxl_unet_step": other["sdxl_unet"], "img2img_unet_calls": i2i_calls,
                    "sdxl_refiner_after_step": s_idx, "checkpoint": ckpt_info,
                    "hires": hr_info, "extras": extras, "sdxl_hires": sdxl_hr_info,
                    "config4": c4_info, "hybrid": hy_info, "img2img_options": opt_info,
                    "faces": face_info, "zoo": zoo_info, "training": train_info,
                    "sdxl_img2img": sdxl_i2i_info, "options": opt4k_info,
                    "scripts": script_info, "saving": save_info, "formats": format_info,
                    "ui": ui_info, "parallel": par_info, "text": text_info,
                    "rare_formats": rare_info, "jpeg2000": j2k_info,
                    "families": {k: v for k, v in family_info.items() if k != "b1_calls"},
                    "requests": requests, "sdxl_profile": other["sdxl_profile"],
                    "phase_s": phase_s}))

    def row_of(name, shape, dtype):
        return next(r for r in rows if r["entry"] == name and r["name"] == shape
                    and r["dtype"] == dtype)

    # B1's row: the VAE shape whose launches in the timed requests times its
    # time is largest: the f32 encode at 512² (one per config 2 request), the
    # 1024² decode (config 3 and config 5 requests), the 768² decode (config
    # 3 at 1.5x), the f32 encode at 1024² (config 3's image-space route and
    # every SDXL img2img request) or the 1536² decode (SDXL hires)
    b1_calls[("vae_mid_512_f32", "float32")] = (len(i2i_results) + hy_info["f32_encodes_512"]
                                                + opt_info["f32_encodes_512"])
    b1_calls[("vae_mid_1024", "bfloat16")] += len(sdxl_results) + sdxl_i2i_info["decodes_1024"]
    b1_calls[("vae_mid_1024_f32", "float32")] += sdxl_i2i_info["f32_encodes_1024"]
    b1_calls[("vae_mid_1536", "bfloat16")] = 1
    b1_calls[("ldsr_vq_256_f32", "float32")] = zoo_info["ldsr_b1_calls"]
    b1_calls[("vae_mid_1024", "bfloat16")] += 1                # phase 4i's hires request
    b1_calls[("vae_mid_512", "bfloat16")] += 1 + script_info["decodes_512"]
    b1_calls[("vae_mid_512_f32", "float32")] += script_info["f32_encodes_512"]
    b1_calls[("vae_mid_512", "bfloat16")] += save_info["decodes_512"]
    b1_calls[("vae_mid_512_f32", "float32")] += save_info["f32_encodes_512"]
    b1_calls[("vae_mid_512", "bfloat16")] += format_info["decodes_512"]
    b1_calls[("vae_mid_512_f32", "float32")] += format_info["f32_encodes_512"]
    b1_calls[("vae_mid_512", "bfloat16")] += rare_info["decodes_512"]
    b1_calls[("vae_mid_512_f32", "float32")] += rare_info["f32_encodes_512"]
    b1_calls[("vae_mid_512", "bfloat16")] += j2k_info["decodes_512"]
    b1_calls[("vae_mid_512_f32", "float32")] += j2k_info["f32_encodes_512"]
    b1_calls[("vae_mid_512", "bfloat16")] += len(ui_results)
    b1_calls[("vae_mid_512", "bfloat16")] += sum(r["launches"]["flash_attention"]
                                                 for r in text_results)
    b1_calls[("vae_mid_1024_f32", "float32")] += 1
    for name, dtype, n in family_info["b1_calls"]:
        b1_calls[(name, dtype)] = b1_calls.get((name, dtype), 0) + n
    b1_row = max(b1_calls, key=lambda c: b1_calls[c] * row_of("flash_attention", *c)["ms"])

    def entry(name, source, replaces, dominant, dtype):
        mine = [r for r in rows if r["entry"] == name]
        row = row_of(name, dominant, dtype) if dominant else row_of(name, *b1_row)
        return {"name": name, "route": "cuda", "source": f"sdwebui_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(r["launches"][name] for r in requests),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    # launches: every timed request of the main paths (SD1.5 txt2img,
    # img2img, hires fix and config 4, from the checkpoint files and with
    # every sampler, SDXL with and without hires fix); the times at each entry's
    # dominant shape; max_abs_err over all its compared shapes
    kernels = [entry(*e) for e in KERNEL_ENTRIES]
    idle = [k["name"] for k in kernels if k["name"] in PATH_KERNELS and not k["launches"]]
    if idle:
        raise AssertionError(f"the main paths never launched {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(second_main(sys.argv[2]) if sys.argv[1:2] == [SECOND] else main())
