"""Single-shot video generation on the port: load a Wan model (UMT5 + the
DiT, or the two-expert DiT pair, or the S2V DiT and its wav2vec encoder,
+ VAE38 or the Wan2.1 VAE) by hash detection, optionally fuse a LoRA,
animate a still (and, with ``--end_image``, end on a second one: the I2V
models), condition on a Fun-Reference image, a VACE control video, a
camera direction or a motion bucket (their models given to the pipeline
as in the JAX package's example), drive an S2V model with a wav
(``--audio``, muxed into the saved video where ffmpeg is found), or
continue a clip with a LongCat-Video DiT (``--longcat_video``).

The twin of examples/wan_inference.py, with its flags and its negative
prompt, plus ``--device`` (default cuda).  Flags of paths the port does not
run yet exit with status 2, naming their ROADMAP item.

Usage:
  python -m fairygen_tpu_torch.examples.wan_inference \\
      --model_paths '["ckpts/dit.safetensors","ckpts/vae.safetensors","ckpts/umt5.safetensors"]' \\
      --tokenizer_path ckpts/umt5-tokenizer \\
      --lora ckpts/merged.safetensors \\
      --input_image data/pig_shot1.png \\
      --prompt "A cartoon pig walking in a forest" \\
      --output outputs/video.mp4
"""
import argparse
import json
import sys

NEGATIVE_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

# flag -> the ROADMAP item that ports its path; given at other than its
# default value, the flag ends the run
UNPORTED_FLAGS = {
    "usp": "ROADMAP.md Queue 1 item 9, parallel/",
    "sp_strategy": "ROADMAP.md Queue 1 item 9, parallel/",
}


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--lora", type=str, default=None)
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--input_image", type=str, default=None)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default=NEGATIVE_PROMPT)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--output", type=str, default="video.mp4")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    p.add_argument("--tiled", action="store_true", help="spatially tiled VAE decode")
    p.add_argument("--vae_frames_per_chunk", type=int, default=1,
                   help="latent frames per streamed VAE decode chunk")
    p.add_argument("--sliding_window_size", type=int, default=None)
    p.add_argument("--sliding_window_stride", type=int, default=None)
    p.add_argument("--tea_cache_l1_thresh", type=float, default=None)
    p.add_argument("--tea_cache_model_id", type=str, default="Wan2.1-T2V-1.3B")
    p.add_argument("--quantize", type=str, default=None, choices=["int8_ffn", "int8"],
                   help="W8A8 int8 DiT projections (the FFN, or all block projections)")
    p.add_argument("--usp", type=int, default=0)
    p.add_argument("--sp_strategy", type=str, default="ulysses", choices=["ulysses", "ring"])
    p.add_argument("--vace_video", type=str, default=None)
    p.add_argument("--vace_video_mask", type=str, default=None)
    p.add_argument("--vace_reference_image", type=str, default=None)
    p.add_argument("--vace_scale", type=float, default=1.0)
    p.add_argument("--camera_control_direction", type=str, default=None,
                   choices=["Left", "Right", "Up", "Down", "LeftUp", "LeftDown", "RightUp",
                            "RightDown"])
    p.add_argument("--camera_control_speed", type=float, default=1 / 54)
    p.add_argument("--motion_bucket_id", type=int, default=None)
    p.add_argument("--end_image", type=str, default=None)
    p.add_argument("--reference_image", type=str, default=None)
    p.add_argument("--audio", type=str, default=None)
    p.add_argument("--audio_sample_rate", type=int, default=None)
    p.add_argument("--longcat_video", type=str, default=None)
    return p


def refuse_unported(p, args):
    """Exit with status 2 when a flag of an unported path was given."""
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag) != p.get_default(flag):
            p.exit(2, f"--{flag}: not ported to fairygen_tpu_torch ({item})\n")


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    refuse_unported(p, args)

    from PIL import Image

    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.utils.video import (load_video_frames, load_wav, save_video,
                                                save_video_with_audio)

    pipe = WanVideoPipeline.from_pretrained(json.loads(args.model_paths),
                                            tokenizer_path=args.tokenizer_path,
                                            device=args.device)
    if args.lora:
        pipe.load_lora(args.lora, alpha=args.lora_alpha)
    if args.quantize:
        pipe.quantize(args.quantize)

    def load_image(path):
        return (Image.open(path).convert("RGB").resize((args.width, args.height))
                if path else None)

    def load_video(path):
        return load_video_frames(path) if path else None

    input_audio = audio_sr = None
    if args.audio:
        input_audio, file_sr = load_wav(args.audio)
        audio_sr = args.audio_sample_rate or file_sr

    frames = pipe(
        prompt=args.prompt, negative_prompt=args.negative_prompt,
        input_audio=input_audio, audio_sample_rate=audio_sr or 16000,
        input_image=load_image(args.input_image), end_image=load_image(args.end_image),
        reference_image=load_image(args.reference_image),
        longcat_video=load_video(args.longcat_video),
        vace_video=load_video(args.vace_video), vace_video_mask=load_video(args.vace_video_mask),
        vace_reference_image=load_image(args.vace_reference_image), vace_scale=args.vace_scale,
        camera_control_direction=args.camera_control_direction,
        camera_control_speed=args.camera_control_speed, motion_bucket_id=args.motion_bucket_id,
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, cfg_scale=args.cfg_scale,
        seed=args.seed, streaming_vae=True, vae_frames_per_chunk=args.vae_frames_per_chunk,
        tiled=args.tiled, sliding_window_size=args.sliding_window_size,
        sliding_window_stride=args.sliding_window_stride,
        tea_cache_l1_thresh=args.tea_cache_l1_thresh,
        tea_cache_model_id=args.tea_cache_model_id)
    if args.audio:
        try:
            out = save_video_with_audio(frames, args.output, args.audio, fps=args.fps, quality=5)
        except Exception as e:
            print(f"audio mux failed ({e}); saving silent video")
            out = save_video(frames, args.output, fps=args.fps, quality=5)
    else:
        out = save_video(frames, args.output, fps=args.fps, quality=5)
    print(f"saved {out}")
    return 0

if __name__ == "__main__":
    sys.exit(main())
