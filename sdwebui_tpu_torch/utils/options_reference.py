"""Copy of ``sdwebui_tpu/utils/options_reference.py``.

Reference option inventory — the remainder of the webui's 282-option
settings surface (modules/shared_options.py) not already covered by the
TPU-specific typed templates in utils/options.py.

Names, defaults, and labels mirror the reference so config.json files and
`/sdapi/v1/options` clients carry over unchanged.  Entries here are plain
data (name, default, label, why) grouped by the reference's section keys.

`why` is the implement-or-reject verdict for each row (VERDICT r4 item 4):

* why=None — the option HAS engine/UI behavior behind it (wired in
  webui.html via uiOpts, or server-side where cited in the why of its
  neighbors); it lives here rather than utils/options.py only because its
  default/label is a pure mirror of the reference row.
* why=str — the option is accepted for config.json compatibility but is a
  no-op in this stack; the string is the one-line justification, and
  `/sdapi/v1/options` returns it in a `warnings` field on writes so a user
  setting it gets told instead of silent acceptance (server/api.py
  set_options).

Rows whose reference behavior is itself display-only (explanation blobs)
carry why=None: their no-op semantics match the reference exactly.
"""

REFERENCE_OPTIONS = [
    (("saving-images", "Saving images/grids"), [
        ('temp_dir', '', 'Directory for temporary images; leave empty for default',
         "gradio streams results through temp files; this SPA returns base64 — no temp images exist"),
        ('clean_temp_dir_at_start', False, 'Cleanup non-default temporary directory when starting webui',
         "no temp-image directory exists (see temp_dir)"),
    ]),
    (("upscaling", "Upscaling"), [
        ('realesrgan_enabled_models', ['R-ESRGAN 4x+', 'R-ESRGAN 4x+ Anime6B'],
         'Select which Real-ESRGAN models to show in the web UI.', None),
        ('dat_enabled_models', ['DAT x2', 'DAT x3', 'DAT x4'],
         'Select which DAT models to show in the web UI.', None),
        ('set_scale_by_when_changing_upscaler', False,
         'Automatically set the Scale by factor based on the name of the selected Upscaler.', None),
    ]),
    (("system", "System"), [
        ('auto_launch_browser', 'Local', 'Automatically open webui in browser on startup',
         "headless container — there is no local browser to launch"),
        ('show_warnings', False, 'Show warnings in console.', None),
        ('show_gradio_deprecation_warnings', True, 'Show gradio deprecation warnings in console.',
         "no gradio in this stack — nothing emits these warnings"),
        ('memmon_poll_rate', 8, 'VRAM usage polls per second during generation.', None),
        ('multiple_tqdm', True, 'Add a second progress bar to the console that shows progress for an entire job.', None),
        ('enable_upscale_progressbar', True, 'Show a progress bar in the console for tiled upscaling.',
         "tiles run as ONE batched device call — there is no per-tile loop to report"),
        ('hide_ldm_prints', True, "Prevent Stability-AI's ldm/sgm modules from printing noise to console.",
         "no ldm/sgm imports exist in this stack"),
    ]),
    (("profiler", "Profiler"), [
        ('profiling_explanation', '\nThose settings allow you to enable torch profiler when generating pictures.\nProfiling allows you to see which code uses how much of computer\'s resources during generation.\nEach generation writes its own profile to one file, overwriting previous.\nThe file can be viewed in <a href="chrome:tracing">Chrome</a>, or on a <a href="https://ui.perfetto.dev/">Perfetto</a> web site.\nWarning: writing profile can take a lot of time, up to 30 seconds, and the file itelf can be around 500MB in size.\n', 'profiling_explanation', None),
        ('profiling_activities', ['CPU'], 'Activities', None),
        ('profiling_record_shapes', True, 'Record shapes',
         "torch.profiler knob; XLA traces always carry shapes"),
        ('profiling_profile_memory', True, 'Profile memory',
         "torch.profiler knob; XLA traces include allocation events unconditionally"),
        ('profiling_with_stack', True, 'Include python stack', None),
    ]),
    (("API", "API"), [
        ('api_useragent', '', 'User agent for requests', None),
    ]),
    (("training", "Training"), [
        ('unload_models_when_training', False, 'Move VAE and CLIP to RAM when training if possible. Saves VRAM.', None),
        ('pin_memory', False, 'Turn on pin_memory for DataLoader. Makes training slightly faster but can increase memory usage.',
         "torch DataLoader knob; host->device feeding uses device_put, JAX exposes no pinned-memory staging"),
        ('training_image_repeats_per_epoch', 1, 'Number of repeats for a single input image per epoch; used only for displaying epoch number', None),
        ('training_xattention_optimizations', False, 'Use cross attention optimizations while training', None),
        ('training_enable_tensorboard', False, 'Enable tensorboard logging.',
         "tensorboard is not in this image; losses stream to CSV via training_write_csv_every"),
        ('training_tensorboard_save_images', False, 'Save generated images within tensorboard.',
         "see training_enable_tensorboard"),
        ('training_tensorboard_flush_every', 120, 'How often, in seconds, to flush the pending tensorboard events and summaries to disk.',
         "see training_enable_tensorboard"),
    ]),
    (("sd", "Stable Diffusion"), [
        ('sd_checkpoints_keep_in_cpu', True, 'Only keep one model on device', None),
        ('sd_unet', 'Automatic', 'SD Unet', None),
        ('enable_batch_seeds', True, 'Make K-diffusion samplers produce same images in a batch as when making a single image',
         "structurally always-true: per-image Philox streams make batches match single-image runs by construction"),
    ]),
    (("vae", "VAE"), [
        ('sd_vae_explanation', "\n<abbr title='Variational autoencoder'>VAE</abbr> is a neural network that transforms a standard <abbr title='red/green/blue'>RGB</abbr>\nimage into latent space representation and back. Latent space representation is what stable diffusion is working on during sampling\n(i.e. when the progress bar is between empty and full). For txt2img, VAE is used to create a resulting image after the sampling is finished.\nFor img2img, VAE is used to process user's input image before the sampling, and to create an image after sampling.\n", 'sd_vae_explanation', None),
        ('auto_vae_precision_bfloat16', False, 'Automatically convert VAE to bfloat16',
         "the VAE already runs bf16 with fp32 islands by the default dtype policy; the NaN-fallback retry is separately implemented"),
    ]),
    (("optimizations", "Optimizations"), [
        ('pad_cond_uncond', False, 'Pad prompt/negative prompt',
         "structurally always-on: the fused CFG batch requires equal cond/uncond chunk counts, so the conditioner always pads (reference behavior with pad_cond_uncond=True)"),
        ('pad_cond_uncond_v0', False, 'Pad prompt/negative prompt (v0)',
         "see pad_cond_uncond; the v0 algorithm reproduced old-version padding bugs"),
    ]),
    (("compatibility", "Compatibility"), [
        ('use_old_emphasis_implementation', False, 'Use old emphasis implementation. Can be useful to reproduce old seeds.', None),
        ('no_dpmpp_sde_batch_determinism', False, 'Do not make DPM++ SDE deterministic across different batch sizes.',
         "N/A: per-image Philox noise streams are batch-size-invariant by construction (the reference's enable_batch_seeds=True behavior)"),
    ]),
    (("extra_networks", "Extra Networks"), [
        ('extra_networks_show_hidden_directories', True, 'Show hidden directories', None),
        ('extra_networks_dir_button_function', False, "Add a '/' to the beginning of directory buttons", None),
        ('extra_networks_hidden_models', 'When searched', 'Show cards for models in hidden directories', None),
        ('extra_networks_card_description_is_html', False, 'Treat card description as HTML',
         "card descriptions render as text; arbitrary HTML injection into the SPA is rejected deliberately (XSS surface)"),
        ('extra_networks_tree_view_style', 'Dirs', 'Extra Networks directory view style', None),
        ('extra_networks_tree_view_default_enabled', True, 'Show the Extra Networks directory view by default', None),
        ('extra_networks_tree_view_default_width', 180, 'Default width for the Extra Networks directory tree view', None),
        ('ui_extra_networks_tab_reorder', '', 'Extra networks tab order', None),
    ]),
    (("ui_prompt_editing", "Prompt editing"), [
        ('keyedit_precision_extra', 0.05, 'Precision for <extra networks:0.9> when editing the prompt with Ctrl+up/down', None),
        ('keyedit_delimiters_whitespace', ['Tab', 'Carriage Return', 'Line Feed'], 'Ctrl+up/down whitespace delimiters', None),
    ]),
    (("ui_gallery", "Gallery"), [
        ('js_modal_lightbox', True, 'Full page image viewer: enable', None),
        ('js_modal_lightbox_initially_zoomed', True, 'Full page image viewer: show images zoomed in by default', None),
        ('js_modal_lightbox_gamepad', False, 'Full page image viewer: navigate with gamepad', None),
        ('js_modal_lightbox_gamepad_repeat', 250, 'Full page image viewer: gamepad repeat period', None),
        ('sd_webui_modal_lightbox_icon_opacity', 1, 'Full page image viewer: control icon unfocused opacity', None),
        ('sd_webui_modal_lightbox_toolbar_opacity', 0.9, 'Full page image viewer: tool bar opacity', None),
        ('open_dir_button_choice', 'Subdirectory', 'What directory the [📂] button opens',
         "headless container — there is no desktop file manager to open"),
    ]),
    (("ui_alternatives", "UI alternatives"), [
        ('compact_prompt_box', False, 'Compact prompt layout', None),
        ('samplers_in_dropdown', True, 'Use dropdown for sampler selection instead of radio group',
         "the SPA always uses a dropdown (the reference's default); the radio alternative is a gradio layout artifact"),
        ('dimensions_and_batch_together', True, 'Show Width/Height and Batch sliders in same row', None),
        ('sd_checkpoint_dropdown_use_short', False, 'Checkpoint dropdown: use filenames without paths', None),
        ('txt2img_settings_accordion', False, 'Settings in txt2img hidden under Accordion', None),
        ('img2img_settings_accordion', False, 'Settings in img2img hidden under Accordion', None),
    ]),
    (("ui", "User interface"), [
        ('ui_reorder_list', [], 'UI item order for txt2img/img2img tabs', None),
        ('gradio_theme', 'Default', 'Gradio theme', None),
        ('gradio_themes_cache', True, 'Cache gradio themes locally',
         "see gradio_theme"),
        ('enable_reloading_ui_scripts', False, 'Reload UI scripts when using Reload UI option',
         "Reload UI restarts the server process, which always reloads everything"),
    ]),
    (("infotext", "Infotext"), [
        ('infotext_explanation', '\nInfotext is what this software calls the text that contains generation parameters and can be used to generate the same picture again.\nIt is displayed in UI below the image. To use infotext, paste it into the prompt and click the ↙️ paste button.\n', 'infotext_explanation', None),
    ]),
    (("ui", "Live previews"), [
        ('live_preview_allow_lowvram_full', False, 'Allow Full live preview method with lowvram/medvram',
         "no lowvram mode exists (functional param trees make module-at-a-time residency moot); Full previews are always allowed"),
        ('js_live_preview_in_modal_lightbox', False, 'Show Live preview in full page image viewer', None),
    ]),
    (("postprocessing", "Postprocessing"), [
        ('postprocessing_enable_in_main_ui', [], 'Enable postprocessing operations in txt2img and img2img tabs', None),
    ]),
    (("None", "Hidden options"), [
        ('sd_checkpoint_hash', '', 'SHA256 hash of the current checkpoint', None),
    ]),
]

#: name -> one-line justification for rows accepted-but-no-op.  Served as
#: `warnings` by POST /sdapi/v1/options writes to these keys.
INERT_WHY = {name: why
             for _section, entries in REFERENCE_OPTIONS
             for (name, _default, _label, why) in entries
             if why is not None}
