"""Wan video pipeline: the TI2V, I2V, video-to-video and two-expert paths
and the conditioned variants (port of fairygen_tpu/pipelines/wan_video.py
``WanVideoPipeline``).

The call: prompt strings through the UMT5 tokenizer and encoder (or
encoded ``context`` / ``negative_context``), noise (``core.noise``), then
the conditioning: the TI2V VAE38 encode of the first frame pinned into
latent frame 0; or, for the I2V DiTs (``require_vae_embedding``), the
4-fold first-frame mask (and the last frame's with ``end_image``) beside
the VAE encode of [first frame, zeros, (end frame)] as the DiT's ``y``
channels, with the CLIP ViT-H features of the first frame where the DiT
takes them (``require_clip_embedding``); ``input_video`` encoded and
noised to the first step's sigma under ``denoising_strength``.
Flow-match Euler steps with CFG as two batch-1 DiT sweeps (or one batch-2
sweep with ``cfg_merge``) and a re-pin of frame 0 after each step, then
the decode: full-sequence, streamed chunk by chunk (``streaming_vae``; the
encodes stream too) or in spatial tiles (``tiled``).  A two-expert pair
(Wan2.2-A14B: ``dit`` for high noise, ``dit2`` below
``switch_dit_boundary``) switches at the first step whose timestep lies
below boundary·1000.  ``sliding_window_size``/``_stride`` denoise
overlapping temporal windows and blend them.  Each expert's per-prompt
cross-attention (k, v) are computed once when it takes over (the first
expert's freed first), but for the sliding window, whose sweeps take the
context as the JAX package's do.

The conditioned variants, with their models set on the pipeline
(``motion_controller_*``, ``vace_*``, ``camera_*``, ``s2v_*``,
``wav2vec_*``, as in the JAX package): ``motion_bucket_id`` (the motion
controller's bias on the block modulation), VACE (``vace_video`` /
``_mask`` / ``_reference_image`` / ``vace_scale``: the control latents and
the pixel-shuffled mask, reference frames rolled to the front of the
noise and dropped after the denoise), camera control
(``camera_control_direction`` / ``_speed``: plücker rays through the
SimpleAdapter, which also makes ``y`` from ``input_image``), Fun-Reference
(``reference_image``, a leading frame of ``ref_conv`` tokens, carried into
every sliding window) and speech-to-video (``audio_embeds``, or
``input_audio`` through wav2vec; ``s2v_pose_video`` / ``_latents``;
``motion_video``: the S2V DiT with zero audio in the CFG branch, the
reference frame re-pinned each step, the motion latents stitched in front
before the decode), Wan-Animate (``animate_pose_video`` /
``_face_video`` / ``_inpaint_video`` / ``_mask_video`` with
``animate_*``: the pose latents in the patch tokens, the face video's
motion tokens through the face blocks, a blank face video in the CFG
branch, the inpaint ``y`` of a reference frame before the background
frames, that frame dropped before the decode), VAP (``vap_video`` with
``vap_*``, ``vap_prompt`` / ``context_vap``: the reference video's latents
and I2V ``y`` through the MoT branch, joint with the main tokens at its
layers) and LongCat-Video (a LongCat DiT in ``longcat_*`` takes every
request; ``longcat_video``'s latents are pinned into the first frames after
each step and the model's output is negated).

``from_pretrained`` finds the DiTs (two files: the expert pair; an S2V or
a LongCat DiT apart by its config), the wav2vec encoder, the VAE38 or the Wan2.1
VAE and UMT5 among checkpoint files by their key hash
(``core.model_pool``); the CLIP image encoder and the conditioning models
above are given to the constructor, as in the JAX package.  LoRAs load
fused into the first expert's weights or hot (``load_lora(hotload=True)``,
cleared by ``clear_lora`` on both).  :meth:`WanVideoPipeline.quantize`
swaps both experts' projections to W8A8 (``ops/quant.py``);
``tea_cache_l1_thresh`` gates each sweep's block stack by TeaCache
(``utils/tea_cache.py``), one state per CFG branch, carried across the
expert switch.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.imaging import (check_resize_height_width, postprocess_video, preprocess_image,
                            preprocess_video)
from ..core.noise import generate_noise
from ..device import resolve_device
from ..diffusion.flow_match import FlowMatchScheduler
from ..models.wan.dit import (WanDiTConfig, precompute_cross_kv, text_kv_hoistable,
                              wan_dit_forward)
from ..models.wan.longcat import longcat_dit_forward
from ..models.wan.mot import wan_dit_forward_vap
from ..models.wan.s2v import wan_s2v_forward
from ..models.wan.text_encoder import UMT5Config, mask_pad_tokens, umt5_encode
from ..models.wan.vae import WanVAEConfig, vae38_decode, vae38_encode

_CAMERA_DIRECTIONS = ("Left", "Right", "Up", "Down", "LeftUp", "LeftDown", "RightUp",
                      "RightDown")


def _as_pil(image, width, height):
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    return image.resize((width, height))


class WanVideoPipeline:
    """Wan pipeline over port params (see ``convert`` and
    ``from_pretrained``): Wan2.2-TI2V-5B, the I2V and T2V DiTs, and with
    ``dit2_params`` the two-expert pairs (both experts under ``dit_cfg``);
    ``image_encoder_params`` / ``image_encoder_cfg``: the CLIP ViT-H of the
    DiTs that take CLIP features; the conditioning models of the variants
    (motion controller, VACE branch, camera SimpleAdapter, S2V DiT and its
    wav2vec encoder, Animate adapter, VAP / MoT branch, LongCat-Video DiT)
    as (params, cfg) pairs.

    ``device`` defaults to "cuda" and raises without a card unless "cpu" is
    asked for; params must already live on that device."""

    def __init__(self, dit_params: Any, dit_cfg: WanDiTConfig, vae_params: Any = None,
                 vae_cfg: Optional[WanVAEConfig] = None, te_params: Any = None,
                 te_cfg: Optional[UMT5Config] = None, dtype=torch.bfloat16, device="cuda",
                 tokenizer=None, dit2_params: Any = None, image_encoder_params: Any = None,
                 image_encoder_cfg=None, motion_controller_params=None,
                 motion_controller_cfg=None, vace_params=None, vace_cfg=None, s2v_params=None,
                 s2v_cfg=None, wav2vec_params=None, wav2vec_cfg=None, camera_params=None,
                 camera_cfg=None, animate_params=None, animate_cfg=None, vap_params=None,
                 vap_cfg=None, longcat_params=None, longcat_cfg=None):
        self.device = resolve_device(device)
        self.dit_params, self.dit_cfg = dit_params, dit_cfg
        self.dit2_params = dit2_params
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.te_params, self.te_cfg = te_params, te_cfg
        self.image_encoder_params, self.image_encoder_cfg = image_encoder_params, image_encoder_cfg
        self.motion_controller_params = motion_controller_params
        self.motion_controller_cfg = motion_controller_cfg
        self.vace_params, self.vace_cfg = vace_params, vace_cfg
        self.s2v_params, self.s2v_cfg = s2v_params, s2v_cfg
        self.wav2vec_params, self.wav2vec_cfg = wav2vec_params, wav2vec_cfg
        self.camera_params, self.camera_cfg = camera_params, camera_cfg
        self.animate_params, self.animate_cfg = animate_params, animate_cfg
        self.vap_params, self.vap_cfg = vap_params, vap_cfg
        self.longcat_params, self.longcat_cfg = longcat_params, longcat_cfg
        self.tokenizer = tokenizer  # utils.tokenizer.HuggingfaceTokenizer
        self.dtype = dtype

    @classmethod
    def from_pretrained(cls, model_paths, tokenizer_path=None, dtype=torch.bfloat16, hints=None,
                        mesh=None, device="cuda"):
        """Hash-detected loading: the DiT, VAE, UMT5 and wav2vec files
        (paths or ``core.model_config.ModelConfig``s, in any order) are
        built on ``device``; the DiTs are told apart by their config (an
        S2V DiT goes to ``s2v_params``, a LongCat-Video DiT to
        ``longcat_params``) and two plain DiT files become the
        (``dit``, ``dit2``) expert pair in the order the pool loaded them.
        ``hints`` maps a path to (model_name, extra_kwargs) for checkpoints
        the registry does not know.  ``tokenizer_path``: a transformers
        tokenizer directory (UMT5's, 512 tokens)."""
        if mesh is not None:
            raise NotImplementedError("mesh= (sequence parallelism) waits for parallel/ on "
                                      "torch.distributed, ROADMAP.md Queue 1 item 9")
        from ..core.model_pool import ModelPool
        from ..models.wan.longcat import LongCatDiTConfig
        from ..models.wan.s2v import S2VConfig

        device = resolve_device(device)
        pool = ModelPool().load(model_paths, dtype=dtype, hints=hints, device=device)
        entries = pool.fetch_model("wan_video_dit", index="all") or []
        s2vs = [e for e in entries if isinstance(e[1], S2VConfig)]
        longcats = [e for e in entries if isinstance(e[1], LongCatDiTConfig)]
        dits = [e for e in entries if not isinstance(e[1], (S2VConfig, LongCatDiTConfig))]
        dit_params, dit_cfg = dits[0] if dits else (None, None)
        dit2_params = dits[1][0] if len(dits) > 1 else None
        s2v = s2vs[0] if s2vs else (None, None)
        longcat = longcats[0] if longcats else (None, None)
        wav2vec = pool.fetch_model("wans2v_audio_encoder") or (None, None)
        vae = pool.fetch_model("wan_video_vae")
        te = pool.fetch_model("wan_video_text_encoder")
        tokenizer = None
        if tokenizer_path is not None:
            from ..utils.tokenizer import HuggingfaceTokenizer

            tokenizer = HuggingfaceTokenizer(tokenizer_path, seq_len=512, clean="whitespace")
        return cls(dit_params, dit_cfg, vae[0] if vae else None, vae[1] if vae else None,
                   te[0] if te else None, te[1] if te else None, dtype=dtype, device=device,
                   tokenizer=tokenizer, dit2_params=dit2_params, s2v_params=s2v[0],
                   s2v_cfg=s2v[1], wav2vec_params=wav2vec[0], wav2vec_cfg=wav2vec[1],
                   longcat_params=longcat[0], longcat_cfg=longcat[1])

    def quantize(self, mode: str = "int8_ffn", *, act_amax=None, alpha: float = 0.5,
                 outlier_k=0):
        """Swap the DiT's block projections to W8A8 (``ops/quant.py``): mode
        "int8_ffn" (the FFN) or "int8" (the FFN and the self- and
        cross-attention projections).  Call after :meth:`load_lora`: a fused
        LoRA is in the float weights it quantizes.  ``act_amax``:
        {group: {name: (L, K)}} calibration statistics
        (``training.quant_experiment.calibrate_wan_dit_act_amax``, or
        ``tools/calibrate_quant.py``'s npz through ``load_act_amax``) for
        the outlier-robust form at ``alpha`` with ``outlier_k`` bf16
        fallback channels (an int, or e.g. {"ffn": {"fc2": 8}}); with two
        experts the same statistics serve both.  Each float weight is
        dropped as its int8 copy is made."""
        from ..ops.quant import quantize_wan_dit_linears

        if mode not in ("int8_ffn", "int8"):
            raise ValueError(f"quantize mode must be 'int8_ffn' or 'int8', got {mode!r}")
        groups = ("ffn",) if mode == "int8_ffn" else ("ffn", "self_attn", "cross_attn")
        kw = dict(act_amax=act_amax, alpha=alpha, outlier_k=outlier_k)
        self.dit_params = quantize_wan_dit_linears(self.dit_params, groups, consume=True, **kw)
        if self.dit2_params is not None:
            self.dit2_params = quantize_wan_dit_linears(self.dit2_params, groups, consume=True,
                                                        **kw)
        return self

    # ------------------------------------------------------------- adapters
    def load_lora(self, lora_path_or_sd, alpha: float = 1.0, hotload: bool = False):
        """A Wan-DiT LoRA (a file or a state dict) fused into the DiT weights,
        or with ``hotload=True`` attached unfused (stacking by rank
        concatenation across calls, removed by :meth:`clear_lora`).  With
        two experts it goes to the first (``dit``) only, as in the JAX
        package."""
        from ..core.io import load_state_dict
        from ..models.adapters import fuse_lora_into_wan_dit, hot_lora_into_wan_dit

        sd = (load_state_dict(lora_path_or_sd) if isinstance(lora_path_or_sd, str)
              else lora_path_or_sd)
        if hotload:
            self.dit_params, n = hot_lora_into_wan_dit(self.dit_params, sd, alpha=alpha,
                                                       dtype=self.dtype)
            print(f"{n} tensors patched by LoRA (hot).")
        else:
            self.dit_params, n = fuse_lora_into_wan_dit(self.dit_params, sd, self.dit_cfg,
                                                        alpha=alpha)
            print(f"{n} tensors fused by LoRA.")
        return self

    def clear_lora(self):
        """Drop every hot-loaded LoRA of both experts (fused ones cannot be
        cleared)."""
        from ..models.adapters import clear_hot_lora

        self.dit_params, n = clear_hot_lora(self.dit_params)
        if self.dit2_params is not None:
            self.dit2_params, n2 = clear_hot_lora(self.dit2_params)
            n += n2
        print(f"{n} LoRA layers cleared.")
        return self

    # ---------------------------------------------------------------- text
    @torch.no_grad()
    def encode_ids(self, ids, mask) -> torch.Tensor:
        """UMT5 on token ids (B, L) -> context zeroed past each length."""
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        emb = umt5_encode(self.te_params, self.te_cfg, ids, mask)
        return mask_pad_tokens(emb, mask).to(self.dtype)

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """A prompt string through the tokenizer and UMT5."""
        if self.tokenizer is None or self.te_params is None:
            raise ValueError("encode_prompt needs a tokenizer and a text encoder "
                             "(from_pretrained(..., tokenizer_path=...))")
        ids, mask = self.tokenizer(prompt, return_mask=True)
        return self.encode_ids(ids, mask)

    # ------------------------------------------------------------- helpers
    def _latent_shape(self, height, width, num_frames):
        f = self.vae_cfg.upsampling_factor
        return (1, self.vae_cfg.z_dim, (num_frames - 1) // 4 + 1, height // f, width // f)

    @torch.no_grad()
    def encode_first_frame(self, input_image):
        """TI2V first-frame latent (1, z, 1, h, w) of a PIL image."""
        img = torch.from_numpy(preprocess_image(input_image)[None, :, None])
        return vae38_encode(self.vae_params, self.vae_cfg,
                            img.to(self.device, self.dtype)).to(self.dtype)

    @torch.no_grad()
    def encode_input_video(self, input_video, tiled=False, tile_size=(34, 34),
                           tile_stride=(18, 16), streaming=False):
        """Video-to-video: frames (PIL images or HWC uint8 arrays) -> latents
        (1, z, (T-1)/4+1, h, w), in spatial tiles with ``tiled`` (whose
        encode streams), else full-sequence or ``streaming``."""
        video = torch.from_numpy(preprocess_video(input_video)).to(self.device, self.dtype)
        return self._encode(video, tiled, tile_size, tile_stride, streaming).to(self.dtype)

    @torch.no_grad()
    def encode_i2v_conditioning(self, input_image, height, width, num_frames, end_image=None,
                                streaming=False):
        """The I2V DiTs' ``y`` (upstream ImageEmbedderVAE): the VAE encode of
        [first frame, zeros, (end frame)] behind 4 mask channels, the
        first frame's mask repeated 4-fold and regrouped into latent frames
        (and the last frame's with ``end_image``).  Returns (1, 4 + z,
        (F-1)/4+1, H/8, W/8)."""
        dev, dt = self.device, self.dtype
        img = torch.from_numpy(preprocess_image(input_image)).to(dev, dt)  # (3, H, W)
        n_mid = num_frames - (2 if end_image is not None else 1)
        parts = [img[:, None], torch.zeros((3, n_mid, height, width), device=dev, dtype=dt)]
        msk = torch.zeros((1, num_frames, height // 8, width // 8), device=dev, dtype=dt)
        msk[:, 0] = 1
        if end_image is not None:
            parts.append(torch.from_numpy(preprocess_image(end_image)).to(dev, dt)[:, None])
            msk[:, -1] = 1
        y = vae38_encode(self.vae_params, self.vae_cfg, torch.cat(parts, dim=1)[None],
                         streaming=streaming)[0]
        msk = torch.cat([msk[:, 0:1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
        msk = msk.reshape(1, msk.shape[1] // 4, 4, height // 8, width // 8).transpose(1, 2)[0]
        return torch.cat([msk, y.to(dt)])[None]

    @torch.no_grad()
    def encode_clip_feature(self, input_image):
        """The CLIP ViT-H features (1, 257, 1280) of a PIL image (upstream
        ImageEmbedderCLIP), in the pipeline's dtype."""
        from ..models.wan.image_encoder import encode_image

        img = torch.from_numpy(preprocess_image(input_image)[None]).to(self.device, self.dtype)
        return encode_image(self.image_encoder_params, self.image_encoder_cfg,
                            img).to(self.dtype)

    def _encode(self, x, tiled=False, tile_size=(34, 34), tile_stride=(18, 16),
                streaming=False):
        """The VAE encode of a video: in spatial tiles (whose encode streams)
        with ``tiled``, else full-sequence or ``streaming``."""
        if tiled:
            from ..models.wan.vae_tiling import vae38_tiled_encode

            return vae38_tiled_encode(self.vae_params, self.vae_cfg, x, tile_size=tile_size,
                                      tile_stride=tile_stride)
        return vae38_encode(self.vae_params, self.vae_cfg, x, streaming=streaming)

    @torch.no_grad()
    def encode_vace_context(self, vace_video, vace_video_mask, vace_reference_image, height,
                            width, num_frames, tiled=False, tile_size=(34, 34),
                            tile_stride=(18, 16), streaming=False):
        """VACE conditioning (upstream WanVideoUnit_VACE): the VAE latents of
        the control video outside and inside the mask, the mask
        pixel-shuffled to 64 channels and resized in time (nearest), and
        each reference image's latent in a leading frame with a zero mask.
        Returns (vace_context (1, 2z + 64, n_ref + T', H/8, W/8), n_ref)."""
        dev, dt = self.device, self.dtype
        if vace_video is None:
            vv = torch.zeros((1, 3, num_frames, height, width), device=dev, dtype=dt)
        else:
            vv = torch.from_numpy(preprocess_video(vace_video)).to(dev, dt)
        if vace_video_mask is None:
            vm = torch.ones_like(vv)
        else:
            vm = torch.from_numpy(preprocess_video(vace_video_mask, min_value=0,
                                                   max_value=1)).to(dev, dt)
            if vm.shape != vv.shape:
                raise ValueError(f"vace_video_mask frames/size {tuple(vm.shape)} must match "
                                 f"vace_video {tuple(vv.shape)}")
        kw = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride, streaming=streaming)
        latents = torch.cat([self._encode(vv * (1 - vm), **kw), self._encode(vv * vm, **kw)],
                            dim=1)
        m = vm[0, 0]  # (T, H, W)
        T, H, W = m.shape
        m = m.reshape(T, H // 8, 8, W // 8, 8).permute(2, 4, 0, 1, 3)
        m = m.reshape(1, 64, T, H // 8, W // 8)
        t_new = (T + 3) // 4
        idx = np.floor((np.arange(t_new, dtype=np.float32) + np.float32(0.5)) * np.float32(T)
                       / np.float32(t_new)).astype(np.int64).clip(0, T - 1)
        mask = m[:, :, torch.from_numpy(idx).to(dev)]
        n_ref = 0
        if vace_reference_image is not None:
            refs = (vace_reference_image if isinstance(vace_reference_image, list)
                    else [vace_reference_image])
            n_ref = len(refs)
            ref = torch.cat([vae38_encode(self.vae_params, self.vae_cfg, torch.from_numpy(
                preprocess_image(r)[None, :, None]).to(dev, dt)) for r in refs], dim=2)
            latents = torch.cat([torch.cat([ref, torch.zeros_like(ref)], dim=1), latents], dim=2)
            mask = torch.cat([torch.zeros_like(mask[:, :, :n_ref]), mask], dim=2)
        return torch.cat([latents.to(dt), mask.to(dt)], dim=1), n_ref

    @torch.no_grad()
    def encode_camera_control(self, direction, speed, input_image, height, width, num_frames,
                              streaming=False):
        """Camera control (upstream WanVideoUnit_FunCameraControl): the
        plücker embedding of the direction's trajectory, grouped 4 frames a
        latent frame, through the SimpleAdapter once (upstream recomputes
        it every step) -> tokens (1, S, D); and ``y``, the first-frame
        latent conditioning of ``input_image``."""
        from ..models.wan.camera import (generate_camera_coordinates, process_pose_file,
                                         simple_adapter_forward)

        if direction not in _CAMERA_DIRECTIONS:
            raise ValueError(f"camera_control_direction {direction!r} not in "
                             f"{_CAMERA_DIRECTIONS}")
        coords = generate_camera_coordinates(direction, num_frames, speed)
        v = process_pose_file(coords, width=width, height=height).transpose(3, 0, 1, 2)[None]
        v = np.concatenate([np.repeat(v[:, :, 0:1], 4, axis=2), v[:, :, 1:]], axis=2)
        b, c, f4, H, W = v.shape
        v = v.transpose(0, 2, 1, 3, 4).reshape(b, f4 // 4, 4, c, H, W)
        v = v.transpose(0, 1, 3, 2, 4, 5).reshape(b, f4 // 4, c * 4, H, W).transpose(0, 2, 1, 3, 4)
        cam = simple_adapter_forward(self.camera_params, self.camera_cfg, torch.from_numpy(
            np.ascontiguousarray(v)).to(self.device, self.dtype))
        tokens = cam.reshape(cam.shape[0], cam.shape[1], -1).transpose(1, 2)
        z = self.vae_cfg.z_dim
        if self.dit_cfg.in_dim - z == z:
            y = torch.zeros(self._latent_shape(height, width, num_frames), device=self.device,
                            dtype=self.dtype)
            y[:, :, :1] = self.encode_first_frame(input_image)
        else:
            y = self.encode_i2v_conditioning(input_image, height, width, num_frames,
                                             streaming=streaming)
        return tokens.to(self.dtype), y

    @torch.no_grad()
    def encode_animate_inpaint(self, inpaint_video, mask_video, ref_image, streaming=False):
        """Wan-Animate's ``y`` (upstream WanVideoUnit_AnimateInpaint): the
        reference image's latent behind a mask of ones as frame 0, then the
        background video's latents behind the inverted mask video,
        nearest-resized to the latent grid and regrouped 4 frames a latent
        frame.  Returns (1, 4 + z, 1 + T', H/8, W/8)."""
        dev, dt = self.device, self.dtype

        def i2v_mask(msk, mask_len):
            # (1, T, h, w) -> (4, (T + 3) / 4, h, w), frame 0 repeated 4-fold
            msk = msk.clone()
            if mask_len:
                msk[:, :mask_len] = 1.0
            msk = torch.cat([msk[:, 0:1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
            msk = msk.reshape(1, msk.shape[1] // 4, 4, msk.shape[2], msk.shape[3])
            return msk.transpose(1, 2)[0]

        bg = torch.from_numpy(preprocess_video(inpaint_video)).to(dev, dt)
        y_reft = vae38_encode(self.vae_params, self.vae_cfg, bg, streaming=streaming)[0]
        _, lat_t, lat_h, lat_w = y_reft.shape
        ref = torch.from_numpy(preprocess_video([ref_image])).to(dev, dt)
        ref_lat = vae38_encode(self.vae_params, self.vae_cfg, ref, streaming=streaming)
        mask_ref = i2v_mask(torch.zeros((1, 1, lat_h, lat_w), device=dev), 1)
        y_ref = torch.cat([mask_ref.to(dt), ref_lat[0].to(dt)])
        mask_pix = 1.0 - torch.from_numpy(preprocess_video(mask_video, min_value=0,
                                                           max_value=1)).to(dev)[0, 0].float()
        ih = torch.arange(lat_h, device=dev) * mask_pix.shape[1] // lat_h
        iw = torch.arange(lat_w, device=dev) * mask_pix.shape[2] // lat_w
        msk_reft = i2v_mask(mask_pix[:, ih][:, :, iw][None], 0)
        y_reft = torch.cat([msk_reft.to(dt), y_reft.to(dt)])
        return torch.cat([y_ref, y_reft], dim=1)[None]

    # ---------------------------------------------------------------- call
    @torch.no_grad()
    def __call__(self, prompt: Optional[str] = None, negative_prompt: str = "", *,
                 context=None, negative_context=None, input_image=None, end_image=None,
                 input_video=None, denoising_strength: float = 1.0, seed: Optional[int] = 0,
                 height: int = 480, width: int = 832, num_frames: int = 81,
                 cfg_scale: float = 5.0, cfg_merge: bool = False,
                 switch_dit_boundary: float = 0.875,
                 num_inference_steps: int = 50, sigma_shift: float = 5.0,
                 motion_bucket_id: Optional[int] = None, vace_video=None, vace_video_mask=None,
                 vace_reference_image=None, vace_scale: float = 1.0, audio_embeds=None,
                 input_audio=None, audio_sample_rate: int = 16000, s2v_pose_video=None,
                 s2v_pose_latents=None, motion_video=None,
                 camera_control_direction: Optional[str] = None,
                 camera_control_speed: float = 1 / 54, reference_image=None,
                 animate_pose_video=None, animate_face_video=None, animate_inpaint_video=None,
                 animate_mask_video=None, vap_video=None, vap_prompt: str = " ",
                 negative_vap_prompt: str = " ", context_vap=None, negative_context_vap=None,
                 longcat_video=None, tiled: bool = False, tile_size: Tuple[int, int] = (30, 52),
                 tile_stride: Tuple[int, int] = (15, 26),
                 sliding_window_size: Optional[int] = None,
                 sliding_window_stride: Optional[int] = None, streaming_vae: bool = False,
                 vae_frames_per_chunk: int = 1, output_type: str = "quantized",
                 torch_compat_noise: bool = False, progress_callback=None,
                 tea_cache_l1_thresh: Optional[float] = None,
                 tea_cache_model_id: str = "Wan2.1-T2V-1.3B"):
        """The JAX pipeline's keywords; ``progress_callback(steps_done,
        total_steps)`` runs after each step.  ``tea_cache_l1_thresh``: the
        TeaCache gate's threshold over ``tea_cache_model_id``'s polynomial
        (``utils.tea_cache``; not with the sliding window).
        ``streaming_vae`` streams the decode and, unlike the JAX package,
        the encodes too (I2V, video, VACE, camera, S2V, Animate, VAP,
        LongCat: the same math within fp32 summation order; a full-sequence
        encode of 81 frames would not fit beside a 14B expert pair).  A
        loaded LongCat DiT takes the request first, then audio goes to S2V
        and ``vap_video`` to VAP; a variant's input without its model raises
        a ``ValueError`` naming the missing argument."""
        seed = 0 if seed is None else seed
        f = self.vae_cfg.upsampling_factor
        height, width, num_frames = check_resize_height_width(
            height, width, num_frames, height_division_factor=f * 2,
            width_division_factor=f * 2, time_division_factor=4, time_division_remainder=1)
        if context is None:
            context = self.encode_prompt(prompt)
        if cfg_scale != 1.0 and negative_context is None:
            if self.tokenizer is None:
                raise ValueError("cfg_scale != 1 needs negative_context (the encoded empty "
                                 "prompt) or a tokenizer for negative_prompt")
            negative_context = self.encode_prompt(negative_prompt)
        context = context.to(self.device, self.dtype)
        use_cfg = cfg_scale != 1.0
        if use_cfg:
            negative_context = negative_context.to(self.device, self.dtype)
        out_kw = dict(output_type=output_type, streaming_vae=streaming_vae,
                      frames_per_chunk=vae_frames_per_chunk)
        if self.longcat_params is not None:
            return self._generate_longcat(
                context, negative_context if use_cfg else None, longcat_video, height=height,
                width=width, num_frames=num_frames, cfg_scale=cfg_scale, seed=seed,
                num_inference_steps=num_inference_steps, sigma_shift=sigma_shift,
                torch_compat_noise=torch_compat_noise, progress_callback=progress_callback,
                **out_kw)

        if input_audio is not None and audio_embeds is None:
            # wav2vec's hidden states -> 30 fps -> buckets of num_frames - 1
            # video frames; the first drives this clip
            from ..models.wan.wav2vec import audio_embeds_from_waveform

            if self.wav2vec_params is None:
                raise ValueError("input_audio needs an audio encoder (wav2vec_params)")
            audio_embeds = audio_embeds_from_waveform(
                self.wav2vec_params, self.wav2vec_cfg, input_audio,
                sample_rate=audio_sample_rate, num_frames=num_frames)[0]
        if audio_embeds is not None:
            if self.s2v_params is None:
                raise ValueError("audio conditioning needs an S2V DiT (s2v_params)")
            return self._generate_s2v(
                context, negative_context if use_cfg else None, audio_embeds,
                input_image=input_image, s2v_pose_video=s2v_pose_video,
                s2v_pose_latents=s2v_pose_latents, motion_video=motion_video, height=height,
                width=width, num_frames=num_frames, cfg_scale=cfg_scale, seed=seed,
                num_inference_steps=num_inference_steps, sigma_shift=sigma_shift,
                streaming_vae=streaming_vae, vae_frames_per_chunk=vae_frames_per_chunk,
                output_type=output_type, torch_compat_noise=torch_compat_noise,
                progress_callback=progress_callback)
        if vap_video is not None:
            if self.vap_params is None:
                raise ValueError("vap_video needs a VAP / MoT branch (vap_params)")
            return self._generate_vap(
                context, negative_context if use_cfg else None, vap_video, vap_prompt,
                negative_vap_prompt, context_vap, negative_context_vap, input_image=input_image,
                end_image=end_image, height=height, width=width, num_frames=num_frames,
                cfg_scale=cfg_scale, seed=seed, num_inference_steps=num_inference_steps,
                sigma_shift=sigma_shift, torch_compat_noise=torch_compat_noise,
                progress_callback=progress_callback, **out_kw)

        cond = {}
        n_ref = 0
        if any(a is not None for a in (vace_video, vace_video_mask, vace_reference_image)):
            if self.vace_params is None:
                raise ValueError("VACE conditioning needs a VACE branch (vace_params)")
            cond["vace_context"], n_ref = self.encode_vace_context(
                vace_video, vace_video_mask, vace_reference_image, height, width, num_frames,
                tiled=tiled, tile_size=tile_size, tile_stride=tile_stride,
                streaming=streaming_vae)
            cond["vace_scale"] = vace_scale
        shape = self._latent_shape(height, width, num_frames)
        shape = shape[:2] + (shape[2] + n_ref,) + shape[3:]
        latents = generate_noise(shape, seed=seed, dtype=self.dtype,
                                 torch_compat=torch_compat_noise, device=self.device)
        if n_ref:  # the reference frames' noise rolled to the front
            latents = torch.cat([latents[:, :, -n_ref:], latents[:, :, :-n_ref]], dim=2)
        scheduler = FlowMatchScheduler("Wan").set_timesteps(
            num_inference_steps, denoising_strength=denoising_strength, shift=sigma_shift)
        if input_video is not None:
            # the call's tile size and stride, as the JAX pipeline passes them
            video = self.encode_input_video(input_video, tiled=tiled, tile_size=tile_size,
                                            tile_stride=tile_stride, streaming=streaming_vae)
            latents = scheduler.add_noise(video, latents, 0)
        first = y = clip_feature = None
        # camera control makes its own y from input_image
        if input_image is not None and camera_control_direction is None:
            cfg = self.dit_cfg
            if cfg.fuse_vae_embedding_in_latents:
                first = self.encode_first_frame(_as_pil(input_image, width, height))
                latents[:, :, 0:1] = first
            elif cfg.require_vae_embedding:
                y = self.encode_i2v_conditioning(
                    _as_pil(input_image, width, height), height, width, num_frames,
                    end_image=None if end_image is None else _as_pil(end_image, width, height),
                    streaming=streaming_vae)
            else:
                raise NotImplementedError(
                    f"input_image given but the loaded DiT config (fuse_vae="
                    f"{cfg.fuse_vae_embedding_in_latents}, require_vae="
                    f"{cfg.require_vae_embedding}) supports no image conditioning path")
            if cfg.require_clip_embedding:
                if self.image_encoder_params is None:
                    raise ValueError("this DiT requires CLIP image conditioning "
                                     "(require_clip_embedding=True) but no image encoder is "
                                     "loaded")
                clip_feature = self.encode_clip_feature(_as_pil(input_image, width, height))
        if reference_image is not None:  # upstream WanVideoUnit_FunReference
            ref = preprocess_video([_as_pil(reference_image, width, height)])
            cond["reference_latents"] = vae38_encode(
                self.vae_params, self.vae_cfg, torch.from_numpy(ref).to(self.device, self.dtype))
            if self.dit_cfg.require_clip_embedding and clip_feature is None:
                clip_feature = self.encode_clip_feature(_as_pil(reference_image, width, height))
        if animate_pose_video is not None and animate_face_video is not None:
            if self.animate_params is None:
                raise ValueError("Animate conditioning needs an Animate adapter (animate_params)")
            if input_video is not None:  # upstream AnimateVideoSplit: 4 frames short
                n_keep = len(input_video) - 4
                animate_pose_video, animate_face_video = (animate_pose_video[:n_keep],
                                                          animate_face_video[:n_keep])
                if animate_inpaint_video is not None:
                    animate_inpaint_video = animate_inpaint_video[:n_keep]
                if animate_mask_video is not None:
                    animate_mask_video = animate_mask_video[:n_keep]
            pv = torch.from_numpy(preprocess_video(animate_pose_video)).to(self.device, self.dtype)
            cond["pose_latents"] = vae38_encode(self.vae_params, self.vae_cfg, pv,
                                                streaming=streaming_vae).to(self.dtype)
            face = torch.from_numpy(preprocess_video(animate_face_video)).to(self.device,
                                                                             self.dtype)
            # the CFG branch takes a blank (-1) face video
            cond["face_pixel_values"], cond["face_nega"] = face, torch.zeros_like(face) - 1
            if animate_inpaint_video is not None and animate_mask_video is not None:
                y = self.encode_animate_inpaint(animate_inpaint_video, animate_mask_video,
                                                _as_pil(input_image, width, height),
                                                streaming=streaming_vae)
        if camera_control_direction is not None:
            if self.camera_params is None:
                raise ValueError("camera control needs a camera adapter (camera_params)")
            if input_image is None:
                raise ValueError("camera control needs input_image")
            cond["control_camera_tokens"], y = self.encode_camera_control(
                camera_control_direction, camera_control_speed,
                _as_pil(input_image, width, height), height, width, num_frames,
                streaming=streaming_vae)
        if motion_bucket_id is not None:
            from ..models.wan.aux_models import motion_controller_forward

            if self.motion_controller_params is None:
                raise ValueError("motion_bucket_id needs motion_controller_params")
            ids = torch.tensor([motion_bucket_id], dtype=torch.float32, device=self.device)
            cond["t_mod_bias"] = motion_controller_forward(
                self.motion_controller_params, self.motion_controller_cfg, ids).to(self.dtype)

        args = (latents, context, negative_context if use_cfg else None, scheduler, first,
                cfg_scale, progress_callback, y, clip_feature,
                self._boundary_index(scheduler, switch_dit_boundary), cond)
        if sliding_window_size is not None:
            if tea_cache_l1_thresh is not None:
                raise ValueError("TeaCache and the temporal sliding window are mutually "
                                 "exclusive (per-window hidden-state shapes break the cache)")
            if any(k in cond for k in ("vace_context", "control_camera_tokens",
                                       "pose_latents")):
                raise ValueError("sliding-window denoising supports text / first-frame / "
                                 "Fun-Reference / motion-bucket conditioning only; VACE, "
                                 "animate and camera control have no defined per-window "
                                 "semantics")
            latents = self._denoise_windowed(*args, sliding_window_size, sliding_window_stride)
        else:
            tea_opts = None
            if tea_cache_l1_thresh is not None:
                tea_opts = dict(model_id=tea_cache_model_id,
                                rel_l1_thresh=float(tea_cache_l1_thresh),
                                num_inference_steps=int(num_inference_steps))
            latents = self._denoise(*args, cfg_merge, tea_opts)
        if n_ref:  # the denoised reference frames go
            latents = latents[:, :, n_ref:]
        if "pose_latents" in cond:  # and Animate's reference-y frame
            latents = latents[:, :, 1:]
        return self._decode_output(latents, tiled=tiled, tile_size=tile_size,
                                   tile_stride=tile_stride, **out_kw)

    def _generate_s2v(self, context, negative_context, audio_embeds, *, input_image,
                      s2v_pose_video, s2v_pose_latents, motion_video, height, width, num_frames,
                      cfg_scale, seed, num_inference_steps, sigma_shift, streaming_vae,
                      vae_frames_per_chunk, output_type, torch_compat_noise, progress_callback):
        """Speech-to-video (upstream WanVideoUnit_S2V, model_fn_wans2v and
        WanVideoPostUnit_S2V): latent frame 0 is the reference image's
        latent, re-pinned after every step; the CFG branch takes zero audio;
        a 73-frame ``motion_video``'s latents run through the frame packer
        and are stitched in front of the result before the decode."""
        dev, dt = self.device, self.dtype
        motion_latents = None
        if motion_video is not None:
            mv = torch.from_numpy(preprocess_video(motion_video)).to(dev, dt)
            if mv.shape[2] != 73:
                raise ValueError(f"motion_video must have 73 frames, got {mv.shape[2]}")
            motion_latents = vae38_encode(self.vae_params, self.vae_cfg, mv,
                                          streaming=streaming_vae)
        if s2v_pose_latents is None and s2v_pose_video is not None:
            infer = num_frames - 1
            pv = torch.from_numpy(preprocess_video(s2v_pose_video)).to(dev, dt)[:, :, :infer]
            if infer > pv.shape[2]:
                pv = torch.cat([pv, -torch.ones((1, 3, infer - pv.shape[2], height, width),
                                                device=dev, dtype=dt)], dim=2)
            pv = torch.cat([pv[:, :, 0:1], pv], dim=2)
            s2v_pose_latents = vae38_encode(self.vae_params, self.vae_cfg, pv,
                                            streaming=streaming_vae)[:, :, 1:]
        if s2v_pose_latents is not None:
            s2v_pose_latents = torch.as_tensor(s2v_pose_latents).to(dev, dt)
        latents = generate_noise(self._latent_shape(height, width, num_frames), seed=seed,
                                 dtype=dt, torch_compat=torch_compat_noise, device=dev)
        ref = None
        if input_image is not None:
            ref = self.encode_first_frame(_as_pil(input_image, width, height))
            latents[:, :, 0:1] = ref
        scheduler = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps,
                                                            shift=sigma_shift)
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)
        audio = torch.as_tensor(np.asarray(audio_embeds)).to(dev, dt)
        kw = dict(motion_latents=motion_latents, pose_cond=s2v_pose_latents,
                  drop_motion_frames=motion_latents is None)
        n = len(scheduler.timesteps)
        for i in range(n):
            t1 = timesteps[i:i + 1].to(dev)
            v = wan_s2v_forward(self.s2v_params, self.s2v_cfg, latents, t1, context, audio, **kw)
            if negative_context is not None:
                v_n = wan_s2v_forward(self.s2v_params, self.s2v_cfg, latents, t1,
                                      negative_context, torch.zeros_like(audio), **kw)
                v = v_n + float(torch.tensor(cfg_scale, dtype=v.dtype)) * (v - v_n)
            latents = scheduler.step(v, i, latents)
            if ref is not None:
                latents[:, :, 0:1] = ref
            if progress_callback is not None:
                progress_callback(i + 1, n)
        if motion_latents is not None:
            latents = torch.cat([motion_latents.to(dt), latents[:, :, 1:]], dim=2)
        return self._decode_output(latents, output_type=output_type,
                                   streaming_vae=streaming_vae,
                                   frames_per_chunk=vae_frames_per_chunk)

    def _generate_vap(self, context, negative_context, vap_video, vap_prompt,
                      negative_vap_prompt, context_vap, negative_context_vap, *, input_image,
                      end_image, height, width, num_frames, cfg_scale, seed, num_inference_steps,
                      sigma_shift, torch_compat_noise, progress_callback, **out_kw):
        """Video as prompt (upstream WanVideoUnit_VAP and the MoT weave of
        model_fn_wan_video): the VAP video's latents beside the I2V ``y`` of
        its first frame (and last, with ``end_image``) ride the MoT branch
        under their own prompt (zeros for the CFG branch without a
        tokenizer) and the CLIP features of the first frame; the main branch
        takes ``input_image``'s ``y`` and CLIP features; Euler steps with
        CFG in the sweeps' dtype, as in the JAX package."""
        dev, dt = self.device, self.dtype
        streaming = out_kw["streaming_vae"]
        if context_vap is None:
            context_vap = self.encode_prompt(vap_prompt)
        context_vap = context_vap.to(dev, dt)
        if negative_context is not None and negative_context_vap is None:
            negative_context_vap = (self.encode_prompt(negative_vap_prompt)
                                    if self.tokenizer is not None
                                    else torch.zeros_like(context_vap))
        first = _as_pil(vap_video[0], width, height)
        vap_clip = self.encode_clip_feature(first) if self.vap_cfg.has_image_input else None
        vv = torch.from_numpy(preprocess_video(vap_video)).to(dev, dt)
        vap_latent = vae38_encode(self.vae_params, self.vae_cfg, vv, streaming=streaming).to(dt)
        y_vap = self.encode_i2v_conditioning(
            first, height, width, num_frames, streaming=streaming,
            end_image=None if end_image is None else _as_pil(vap_video[-1], width, height))
        vap_hidden_state = torch.cat([vap_latent, y_vap], dim=1)
        y = clip_feature = None
        if input_image is not None:
            img = _as_pil(input_image, width, height)
            if self.dit_cfg.require_vae_embedding:
                y = self.encode_i2v_conditioning(
                    img, height, width, num_frames, streaming=streaming,
                    end_image=None if end_image is None else _as_pil(end_image, width, height))
            if self.dit_cfg.require_clip_embedding:
                clip_feature = self.encode_clip_feature(img)
        latents = generate_noise(self._latent_shape(height, width, num_frames), seed=seed,
                                 dtype=dt, torch_compat=torch_compat_noise, device=dev)
        scheduler = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps,
                                                            shift=sigma_shift)
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)

        def sweep(t1, ctx, ctx_vap):
            return wan_dit_forward_vap(
                self.dit_params, self.dit_cfg, self.vap_params, self.vap_cfg, latents, t1, ctx,
                clip_feature=clip_feature, y=y, vap_hidden_state=vap_hidden_state,
                context_vap=ctx_vap, vap_clip_feature=vap_clip)

        n = len(scheduler.timesteps)
        for i in range(n):
            t1 = timesteps[i:i + 1].to(dev)
            v = sweep(t1, context, context_vap)
            if negative_context is not None:
                v_n = sweep(t1, negative_context, negative_context_vap.to(dev, dt))
                v = v_n + float(torch.tensor(cfg_scale, dtype=v.dtype)) * (v - v_n)
            latents = scheduler.step(v, i, latents)
            if progress_callback is not None:
                progress_callback(i + 1, n)
        return self._decode_output(latents, **out_kw)

    def _generate_longcat(self, context, negative_context, longcat_video, *, height, width,
                          num_frames, cfg_scale, seed, num_inference_steps, sigma_shift,
                          torch_compat_noise, progress_callback, **out_kw):
        """LongCat-Video (upstream WanVideoUnit_LongCatVideo and
        model_fn_longcat_video): text to video, or with ``longcat_video`` a
        continuation whose latents fill the first frames (in cond mode) and
        are pinned there again after each step; the DiT's fp32 output is
        negated and combined for CFG in fp32."""
        dev, dt = self.device, self.dtype
        latents = generate_noise(self._latent_shape(height, width, num_frames), seed=seed,
                                 dtype=dt, torch_compat=torch_compat_noise, device=dev)
        cond, num_cond = None, 0
        if longcat_video is not None:
            lv = torch.from_numpy(preprocess_video(longcat_video)).to(dev, dt)
            cond = vae38_encode(self.vae_params, self.vae_cfg, lv,
                                streaming=out_kw["streaming_vae"]).to(dt)
            num_cond = cond.shape[2]
            latents[:, :, :num_cond] = cond
        scheduler = FlowMatchScheduler("Wan").set_timesteps(num_inference_steps,
                                                            shift=sigma_shift)
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)
        n = len(scheduler.timesteps)
        for i in range(n):
            t1 = timesteps[i:i + 1].to(dev)
            v = -longcat_dit_forward(self.longcat_params, self.longcat_cfg, latents, t1, context,
                                     num_cond_latents=num_cond)
            if negative_context is not None:
                v_n = -longcat_dit_forward(self.longcat_params, self.longcat_cfg, latents, t1,
                                           negative_context, num_cond_latents=num_cond)
                v = v_n + float(torch.tensor(cfg_scale, dtype=v.dtype)) * (v - v_n)
            latents = scheduler.step(v, i, latents)
            if cond is not None:
                latents[:, :, :num_cond] = cond
            if progress_callback is not None:
                progress_callback(i + 1, n)
        return self._decode_output(latents, **out_kw)

    def _boundary_index(self, scheduler, switch_dit_boundary):
        """The first step of ``dit2``: the first whose timestep lies below
        boundary·1000 (a step at the boundary stays with ``dit``); the step
        count without a second expert."""
        n = len(scheduler.timesteps)
        if self.dit2_params is None:
            return n
        return int(np.searchsorted(-np.asarray(scheduler.timesteps),
                                   -switch_dit_boundary * 1000, side="right"))

    def _sweep(self, params, latents, t1, fuse, cross_kv=None, context=None, y=None,
               clip_feature=None, cond=None, negative=False, **tea):
        """One DiT sweep of ``params`` (an expert) under the conditioning
        ``cond`` (``wan_dit_forward``'s keywords; per-sample inputs repeated
        to a merged CFG batch; Animate's face video, or with ``negative``
        its blank one, or both for a merged batch); with ``tea``
        (tea_cache_state, tea_cache_opts) it returns (output, new state)."""
        cond = dict(cond or {})
        b = latents.shape[0]
        if "pose_latents" in cond:
            face, nega = cond.pop("face_pixel_values"), cond.pop("face_nega")
            face = nega if negative else face
            cond["face_pixel_values"] = face if face.shape[0] == b else torch.cat([face, nega])
            cond.update(animate_params=self.animate_params, animate_cfg=self.animate_cfg)
        for k in ("control_camera_tokens", "reference_latents", "vace_context", "pose_latents"):
            if cond.get(k) is not None and cond[k].shape[0] != b:
                cond[k] = torch.cat([cond[k]] * (b // cond[k].shape[0]))
        if "vace_context" in cond:
            cond.update(vace_params=self.vace_params, vace_cfg=self.vace_cfg)
        return wan_dit_forward(params, self.dit_cfg, latents, t1, context, y=y,
                               clip_feature=clip_feature, fuse_vae_embedding_in_latents=fuse,
                               cross_kv=cross_kv, **cond, **tea)

    def _init_tea_states(self, latents, *, use_cfg, cfg_merge, fuse):
        """fp32 TeaCache states shaped for the DiT's tokens and t_mod rows:
        one per CFG branch, or one batch-2 state with ``cfg_merge``."""
        from ..utils.tea_cache import init_tea_cache_state

        cfg = self.dit_cfg
        b, _, f, h, w = latents.shape
        pt, ph, pw = cfg.patch_size
        b_eff = 2 * b if (use_cfg and cfg_merge) else b
        seg = cfg.seperated_timestep and fuse
        t_mod_shape = (b_eff, 2 if seg else 1, 6, cfg.dim)
        hidden_shape = (b_eff, (f // pt) * (h // ph) * (w // pw), cfg.dim)
        tea_a = init_tea_cache_state(t_mod_shape, hidden_shape, device=self.device)
        tea_b = (init_tea_cache_state(t_mod_shape, hidden_shape, device=self.device)
                 if (use_cfg and not cfg_merge) else None)
        return tea_a, tea_b

    def _denoise(self, latents, context, negative_context, scheduler, first, cfg_scale,
                 progress_callback, y, clip_feature, boundary, cond, cfg_merge, tea_opts=None):
        """The steps: two batch-1 sweeps for CFG, or with ``cfg_merge`` one
        batch-2 sweep over [prompt, negative prompt]; the guidance combine
        in fp32, as in the JAX package.  Steps before ``boundary`` run
        ``dit``, the rest ``dit2``; each expert's text (k, v) are made when
        it takes over (for the I2V DiTs too, beside their image branch:
        the JAX package projects them in every block there, the same ops).
        ``tea_opts``: TeaCache's options, with one gate state per sweep of a
        step, carried across the switch.  ``cond``: the sweeps' conditioning
        (the VACE blocks take the prompt's context beside the hoisted
        (k, v))."""
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)
        n, fuse = len(scheduler.timesteps), first is not None
        merge = negative_context is not None and cfg_merge
        tea = [None, None]
        if tea_opts is not None:
            tea = list(self._init_tea_states(latents, use_cfg=negative_context is not None,
                                             cfg_merge=cfg_merge, fuse=fuse))
        # the JAX package projects the text (k, v) in every Animate block
        hoist = text_kv_hoistable(self.dit_cfg, clip_feature) and "pose_latents" not in cond
        vace = "vace_context" in cond
        if merge:
            y2 = None if y is None else torch.cat([y, y])
            clip2 = None if clip_feature is None else torch.cat([clip_feature, clip_feature])

        for params, start, stop in ((self.dit_params, 0, boundary),
                                    (self.dit2_params, boundary, n)):
            if start >= stop:
                continue

            def sweep(lat, t, kv, ctx, branch, y_, clip_):
                kw = dict(cross_kv=kv, context=None if hoist and not vace else ctx, y=y_,
                          clip_feature=clip_, cond=cond, negative=branch == 1)
                if tea_opts is None:
                    return self._sweep(params, lat, t, fuse, **kw)
                v, tea[branch] = self._sweep(params, lat, t, fuse, **kw,
                                             tea_cache_state=tea[branch],
                                             tea_cache_opts=tea_opts)
                return v

            ckv = ckv_n = None
            if merge:
                ctx2 = torch.cat([context, negative_context])
                if hoist:
                    ckv = precompute_cross_kv(params, self.dit_cfg, ctx2)
            elif hoist:
                ckv = precompute_cross_kv(params, self.dit_cfg, context)
                if negative_context is not None:
                    ckv_n = precompute_cross_kv(params, self.dit_cfg, negative_context)
            for i in range(start, stop):
                t1 = timesteps[i:i + 1].to(self.device)
                if merge:
                    v2 = sweep(torch.cat([latents, latents]), t1.repeat(2), ckv, ctx2, 0, y2,
                               clip2)
                    v, v_n = v2[:1], v2[1:]
                else:
                    v = sweep(latents, t1, ckv, context, 0, y, clip_feature)
                    if negative_context is not None:
                        v_n = sweep(latents, t1, ckv_n, negative_context, 1, y, clip_feature)
                if negative_context is not None:
                    v = v_n.float() + cfg_scale * (v - v_n).float()
                latents = scheduler.step(v, i, latents)
                if fuse:
                    latents[:, :, 0:1] = first
                if progress_callback is not None:
                    progress_callback(i + 1, n)
            del ckv, ckv_n  # this expert's (k, v) go before the next expert's are made
        return latents

    def _denoise_windowed(self, latents, context, negative_context, scheduler, first,
                          cfg_scale, progress_callback, y, clip_feature, boundary, cond,
                          window_size, window_stride):
        """Long videos: each step denoises overlapping temporal windows
        (each sweep with the prompt's context, the expert of its step, the
        window's frames of ``y``, the whole Fun-Reference latent and motion
        bias of ``cond``; CFG combined per window in the sweep's dtype, as
        the JAX package's windowed path does) and blends them in fp32
        (``utils.temporal_tiler``)."""
        from ..utils.temporal_tiler import temporal_tiled_model_fn

        if window_stride is None:
            raise ValueError("sliding_window_size needs sliding_window_stride")
        timesteps = torch.tensor(scheduler.timesteps, dtype=torch.float32)
        n, fuse = len(scheduler.timesteps), first is not None
        for i in range(n):
            t1 = timesteps[i:i + 1].to(self.device)
            params = self.dit_params if i < boundary else self.dit2_params

            def model_fn(window, y=None):
                kw = dict(y=y, clip_feature=clip_feature, cond=cond)
                v = self._sweep(params, window, t1, fuse, context=context, **kw)
                if negative_context is not None:
                    v_n = self._sweep(params, window, t1, fuse, context=negative_context, **kw)
                    v = v_n + float(torch.tensor(cfg_scale, dtype=v.dtype)) * (v - v_n)
                return v

            v = temporal_tiled_model_fn(model_fn, latents, window_size, window_stride,
                                        sliced_kwargs={"y": y})
            latents = scheduler.step(v, i, latents)
            if fuse:
                latents[:, :, 0:1] = first
            if progress_callback is not None:
                progress_callback(i + 1, n)
        return latents

    def _decode_output(self, latents, *, output_type, streaming_vae=False, frames_per_chunk=1,
                       tiled=False, tile_size=(30, 52), tile_stride=(15, 26)):
        """latents -> (tiled / streamed / full-sequence) VAE decode ->
        floatpoint video or quantized frames."""
        if self.vae_params is None or output_type == "latents":
            return latents
        if tiled:
            from ..models.wan.vae_tiling import vae38_tiled_decode

            video = vae38_tiled_decode(self.vae_params, self.vae_cfg, latents.to(self.dtype),
                                       tile_size=tile_size, tile_stride=tile_stride)
        else:
            video = vae38_decode(self.vae_params, self.vae_cfg, latents.to(self.dtype),
                                 streaming=streaming_vae, frames_per_chunk=frames_per_chunk)
        if output_type == "floatpoint":
            return video
        return postprocess_video(video.float().cpu().numpy())
