"""Two-stage propagated-motion-adapter finetune of Wan2.2-TI2V-5B on the port.

The twin of examples/wan_train.py, with its flags and tasks, plus
``--device`` (default cuda):

  stage 1 (identity): LoRA r 32 on q, k, v, o, ffn.0, ffn.2 with element
    dropout p = 0.8 on B; the first video frame is the conditioning image
    (``--extra_inputs input_image``).
  stage 2 (motion): ``--lora_checkpoint <stage1.safetensors>`` loads A1/B1
    into the adapter slots and freezes them; a zero-init B2 trains with
    dropout 0.5.

Tasks: ``sft`` (preprocess each sample on the fly, cached in memory per
unique sample), ``sft:data_process`` (cache the VAE38 latents and UMT5
context of every sample as ``.npz`` under ``--output_path`` and stop),
``sft:train`` (train from such a cache: ``--dataset_base_path`` is the
cache directory), and ``direct_distill`` (few-step distillation of the
student's own ``--distill_steps`` rollout onto the clean latents).  Mesh,
FSDP and pipeline training exit with status 2 (ROADMAP.md Queue 1 item 9).

Usage (stage 1):
  python -m fairygen_tpu_torch.examples.wan_train \\
      --dataset_base_path data/pig_walk --dataset_metadata_path data/pig_walk/metadata.csv \\
      --dataset_repeat 300 \\
      --model_paths '["dit.safetensors","vae.safetensors","umt5.safetensors"]' \\
      --tokenizer_path ckpts/umt5-tokenizer --extra_inputs input_image \\
      --height 480 --width 832 --num_frames 81 \\
      --lora_base_model dit --lora_rank 32 --output_path ./stage1 --save_steps 100
"""
import argparse
import json
import sys

import numpy as np

_PARALLEL = "ROADMAP.md Queue 1 item 9, parallel/"


def parser():
    from fairygen_tpu_torch.training.parsers import add_general_config, add_video_size_config

    p = argparse.ArgumentParser()
    p = add_video_size_config(add_general_config(p))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions of the kernels")
    return p


def refuse_unported(p, args):
    """Exit with status 2 for mesh, FSDP or pipeline training."""
    for flag, value in (("mesh_data", args.mesh_data), ("mesh_seq", args.mesh_seq),
                        ("mesh_pipe", args.mesh_pipe)):
        if value > 1:
            p.exit(2, f"--{flag} {value}: multi-card training is not ported to "
                      f"fairygen_tpu_torch ({_PARALLEL})\n")
    if args.fsdp or args.pp_microbatches is not None:
        flag = "--fsdp" if args.fsdp else "--pp_microbatches"
        p.exit(2, f"{flag}: not ported to fairygen_tpu_torch ({_PARALLEL})\n")


def video_collate(pipe):
    """sample {"video": frames, "prompt": str} -> {"latents": VAE38 encode
    (streamed) in the pipeline's dtype, "context": UMT5 context}; frames are
    PIL images or HWC uint8 arrays.  One encode per unique (prompt, frame
    count), kept in memory, as the JAX CLI does."""
    import torch

    from fairygen_tpu_torch.core.imaging import preprocess_video
    from fairygen_tpu_torch.models.wan.vae import vae38_encode

    cache = {}

    @torch.no_grad()
    def collate(sample):
        sid = sample.get("prompt", "") + str(len(sample.get("video", [])))
        if sid not in cache:
            video = torch.from_numpy(preprocess_video(sample["video"]))
            latents = vae38_encode(pipe.vae_params, pipe.vae_cfg,
                                   video.to(pipe.device, pipe.dtype), streaming=True)
            cache[sid] = {"latents": latents.to(pipe.dtype),
                          "context": pipe.encode_prompt(sample["prompt"])}
        return cache[sid]

    return collate


def cached_collate(sample):
    """A ``.npz`` cache entry -> the batch: float arrays back to bf16 (the
    cache holds float32), integer arrays as they are."""
    import torch

    return {k: (torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
                if np.issubdtype(np.asarray(v).dtype, np.floating) else v)
            for k, v in sample.items()}


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    refuse_unported(p, args)
    # only the DiT trains (the VAE and the text encoder are frozen
    # preprocessing): refuse other selections before loading checkpoints
    for flag, val in (("trainable_models", args.trainable_models),
                      ("lora_base_model", args.lora_base_model)):
        if val not in (None, "dit"):
            p.error(f"--{flag}={val}: only 'dit' is trainable here "
                    "(VAE/text encoder run as frozen preprocessing)")
    extra_inputs = args.extra_inputs.split(",") if args.extra_inputs else []
    unknown = [e for e in extra_inputs if e != "input_image"]
    if unknown:
        p.error(f"--extra_inputs {unknown}: only input_image is supported "
                "(first-frame conditioning, train.py:65-70)")

    import torch

    from fairygen_tpu_torch.core.io import load_state_dict
    from fairygen_tpu_torch.data import UnifiedDataset
    from fairygen_tpu_torch.device import resolve_device
    from fairygen_tpu_torch.models.adapters import (
        add_lora_to_wan_dit, lora_trainable_filter, set_lora_weights)
    from fairygen_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from fairygen_tpu_torch.training.optimizers import make_optimizer
    from fairygen_tpu_torch.training.runner import (
        ModelLogger, launch_training_task, restore_train_state)
    from fairygen_tpu_torch.training.train_step import (
        make_wan_distill_train_step, make_wan_sft_train_step)

    device = resolve_device(args.device)
    pipe = WanVideoPipeline.from_pretrained(json.loads(args.model_paths),
                                            tokenizer_path=args.tokenizer_path, device=device)
    if args.task.endswith(":train"):
        dataset = UnifiedDataset(base_path=args.dataset_base_path, metadata_path=None,
                                 repeat=args.dataset_repeat)
        collate = cached_collate
    else:
        dataset = UnifiedDataset(
            base_path=args.dataset_base_path, metadata_path=args.dataset_metadata_path,
            repeat=args.dataset_repeat, data_file_keys=tuple(args.data_file_keys.split(",")),
            main_data_operator=UnifiedDataset.default_video_operator(
                base_path=args.dataset_base_path, height=args.height, width=args.width,
                max_pixels=args.max_pixels, num_frames=args.num_frames))
        collate = video_collate(pipe)
    if args.task.endswith(":data_process"):
        # the two-phase run's first phase (upstream runner.py:50-71)
        from fairygen_tpu_torch.training.data_process import launch_data_process_task

        launch_data_process_task(dataset, collate, args.output_path)
        return 0

    g = torch.Generator(device).manual_seed(0)
    stage2 = args.lora_checkpoint is not None
    params = add_lora_to_wan_dit(pipe.dit_params, g, rank=args.lora_rank,
                                 targets=tuple(args.lora_target_modules.split(",")),
                                 with_b2=stage2)
    if stage2:
        n = set_lora_weights(params, load_state_dict(args.lora_checkpoint))
        print(f"stage 2: A1/B1 of {n} layers from {args.lora_checkpoint}")
    optimizer = make_optimizer(args.optimizer, args.learning_rate, args.weight_decay,
                               args.max_grad_norm)
    trainable = lora_trainable_filter(("B2",) if stage2 else ("A", "B"))
    remat = ("offload" if args.use_gradient_checkpointing_offload
             else args.use_gradient_checkpointing)
    if args.task.startswith("direct_distill"):
        init_state, train_step = make_wan_distill_train_step(
            pipe.dit_cfg, optimizer, num_inference_steps=args.distill_steps, remat=remat,
            trainable_filter=trainable, device=device)
    else:
        init_state, train_step = make_wan_sft_train_step(
            pipe.dit_cfg, optimizer, remat=remat, trainable_filter=trainable,
            lora_b_dropout=("B2", 0.5) if stage2 else ("B", 0.8),
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            first_frame_clean=True if "input_image" in extra_inputs else None, device=device)
    state = init_state(params)
    if args.resume_from:
        state = restore_train_state(args.resume_from, state, g)
        print(f"resumed from {args.resume_from} at step {state.step}")
    logger = ModelLogger(args.output_path, remove_prefix_in_ckpt=args.remove_prefix_in_ckpt,
                         async_save=args.async_checkpoint)
    launch_training_task(state, train_step, dataset, collate, num_epochs=args.num_epochs,
                         save_steps=args.save_steps, logger=logger, generator=g,
                         preemption_checkpoint=args.preemption_checkpoint,
                         shuffle=args.dataset_shuffle, num_workers=args.dataset_num_workers,
                         device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
