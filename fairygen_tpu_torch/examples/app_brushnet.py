"""Gradio inpainting app over the port's SD1.5 + BrushNet pipeline: upload an
image and a black / white mask (or draw one), type a prompt, and inpaint the
white region with BrushNet guidance under UniPC.  The twin of
examples/app_brushnet.py: the mask and blend logic are plain functions, and
the UI layer needs ``gradio``, an optional dependency, which it imports
only when the demo is built (with the JAX app's message where it is
missing).  Plus ``--device`` (default cuda).

  python -m fairygen_tpu_torch.examples.app_brushnet --unet ... --brushnet ... \\
      --vae ... --te ... --tokenizer ... [--port 7860]
"""
import argparse
import sys

import numpy as np


def resize_image(input_image: np.ndarray, resolution: int) -> np.ndarray:
    """Shortest-side resize snapped to /64 (app_brushnet.py:50-60)."""
    from PIL import Image

    h, w = input_image.shape[:2]
    k = float(resolution) / min(h, w)
    h2 = int(np.round(h * k / 64.0)) * 64
    w2 = int(np.round(w * k / 64.0)) * 64
    resample = Image.LANCZOS if k > 1 else Image.BOX
    return np.asarray(Image.fromarray(input_image).resize((w2, h2), resample))


def prepare_mask_and_image(original_image: np.ndarray, original_mask: np.ndarray = None,
                           input_mask: np.ndarray = None, invert_mask: bool = False):
    """The reference ``process()``'s mask plumbing (app_brushnet.py:86-101):
    returns (masked image, uint8 HWC; mask, float HW1 in {0, 1}), mask 1 =
    the region to inpaint."""
    if original_image is None:
        raise ValueError("Please upload the input image")
    if original_mask is None and input_mask is None:
        raise ValueError("Please click the region you want changed, or upload a "
                         "white-black mask image")
    if input_mask is not None:
        from PIL import Image

        h, w = original_image.shape[:2]
        if input_mask.ndim == 2:
            input_mask = np.repeat(input_mask[..., None], 3, axis=-1)
        original_mask = np.asarray(Image.fromarray(input_mask.astype(np.uint8)).resize((w, h)))
    else:
        # the SAM path returns "keep" masks; flip them to "inpaint"
        original_mask = np.clip(255 - original_mask.astype(np.int32), 0, 255).astype(np.uint8)
    if invert_mask:
        original_mask = 255 - original_mask
    if original_mask.ndim == 2:
        original_mask = np.repeat(original_mask[..., None], 3, axis=-1)
    mask = 1.0 * (original_mask.sum(-1) > 255)[:, :, None]
    masked_image = (original_image * (1 - mask)).astype(np.uint8)
    return masked_image, mask.astype(np.float32)


def run_inpaint(pipe, original_image: np.ndarray, mask_hw1: np.ndarray, prompt: str,
                negative_prompt: str = "", blended: bool = False, control_strength: float = 1.0,
                seed: int = 1234, guidance_scale: float = 7.5, num_inference_steps: int = 50):
    """One pipeline call with the app's conventions (app_brushnet.py:103-136)."""
    if blended and control_strength < 1.0:
        raise ValueError("Blurred blending with control strength below 1.0 is not allowed")
    masked = (original_image.astype(np.float32) / 255.0) * (1.0 - mask_hw1)
    h, w = original_image.shape[:2]
    return pipe(prompt=prompt, negative_prompt=negative_prompt, image=masked,
                mask=mask_hw1[..., 0], height=h, width=w, num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale, brushnet_conditioning_scale=float(control_strength),
                seed=int(seed), blended=blended,
                original_image=original_image.astype(np.float32) / 255.0)


def build_demo(pipe, max_resolution: int = 768):
    """The Gradio Blocks UI (gradio imported here, raising where missing)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("the BrushNet app needs gradio (`pip install gradio`); the same "
                           "pipeline is scriptable via examples/brushnet_inpaint_sd15.py") from e
    import random

    def process(input_image, input_mask, prompt, negative_prompt, blended, invert_mask,
                control_strength, seed, randomize_seed, guidance_scale, num_inference_steps):
        image = resize_image(np.asarray(input_image), max_resolution)
        mask = np.asarray(input_mask) if input_mask is not None else None
        try:
            _, m = prepare_mask_and_image(image, input_mask=mask, invert_mask=invert_mask)
            if randomize_seed:
                seed = random.randint(0, 2147483647)
            out = run_inpaint(pipe, image, m, prompt, negative_prompt, blended,
                              control_strength, seed, guidance_scale, int(num_inference_steps))
        except ValueError as err:
            raise gr.Error(str(err))
        return out, seed

    with gr.Blocks() as demo:
        gr.Markdown("# FairyGen-TPU — BrushNet inpainting")
        with gr.Row():
            with gr.Column():
                input_image = gr.Image(label="Image", type="numpy")
                input_mask = gr.Image(label="Mask (white = inpaint)", type="numpy")
                prompt = gr.Textbox(label="Prompt")
                negative_prompt = gr.Textbox(label="Negative prompt", value="ugly, low quality")
                with gr.Accordion("Advanced options", open=False):
                    blended = gr.Checkbox(label="Blurred blending", value=False)
                    invert_mask = gr.Checkbox(label="Invert mask", value=False)
                    control_strength = gr.Slider(label="Control strength", minimum=0.0,
                                                 maximum=1.1, value=1.0, step=0.01)
                    seed = gr.Slider(label="Seed", minimum=0, maximum=2147483647, step=1,
                                     value=1234)
                    randomize_seed = gr.Checkbox(label="Randomize seed", value=False)
                    guidance_scale = gr.Slider(label="Guidance scale", minimum=0.1,
                                               maximum=30.0, value=7.5, step=0.1)
                    num_inference_steps = gr.Slider(label="Steps", minimum=1, maximum=100,
                                                    value=50, step=1)
                run_button = gr.Button("Run")
            with gr.Column():
                gallery = gr.Gallery(label="Result", show_label=True)
                used_seed = gr.Number(label="Seed used")
        run_button.click(fn=process,
                         inputs=[input_image, input_mask, prompt, negative_prompt, blended,
                                 invert_mask, control_strength, seed, randomize_seed,
                                 guidance_scale, num_inference_steps],
                         outputs=[gallery, used_seed])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--unet", type=str, required=True)
    p.add_argument("--brushnet", type=str, required=True)
    p.add_argument("--vae", type=str, required=True)
    p.add_argument("--te", type=str, required=True)
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

    from fairygen_tpu_torch.examples.brushnet_inpaint_sd15 import load_pipeline

    demo = build_demo(load_pipeline(args))
    demo.queue().launch(server_port=args.port, share=args.share)
    return 0


if __name__ == "__main__":
    sys.exit(main())
