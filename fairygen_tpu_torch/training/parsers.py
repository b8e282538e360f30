"""Shared CLI flag groups of the trainers (port of
fairygen_tpu/training/parsers.py, itself after the upstream
``animation/diffsynth/diffusion/parsers.py``): the same flags with the same
defaults.  The port trains on one card, so the mesh flags, ``--fsdp`` and
``--pp_microbatches`` exist only to be refused above their defaults
(``examples/wan_train.py``)."""
import argparse


def add_dataset_base_config(parser):
    parser.add_argument("--dataset_base_path", type=str, default="", required=True)
    parser.add_argument("--dataset_metadata_path", type=str, default=None)
    parser.add_argument("--dataset_repeat", type=int, default=1)
    parser.add_argument("--dataset_num_workers", type=int, default=1,
                        help="loader threads preparing samples ahead of the "
                             "device step (reference parsers.py:8; 0 = "
                             "synchronous)")
    parser.add_argument("--dataset_shuffle", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="seeded per-epoch permutation (the reference "
                             "trains with DataLoader(shuffle=True), "
                             "runner.py:29)")
    parser.add_argument("--data_file_keys", type=str, default="image,video")
    return parser


def add_video_size_config(parser):
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--max_pixels", type=int, default=1024 * 1024)
    parser.add_argument("--num_frames", type=int, default=81)
    return parser


def add_model_config(parser):
    parser.add_argument("--model_paths", type=str, default=None,
                        help="JSON list of checkpoint paths (hash-detected).")
    parser.add_argument("--tokenizer_path", type=str, default=None)
    parser.add_argument("--extra_inputs", default=None,
                        help="Additional model inputs, comma-separated (e.g. input_image).")
    return parser


def add_training_config(parser):
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--trainable_models", type=str, default=None)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--optimizer", type=str, default="adamw",
                        choices=["adamw", "adafactor", "sgd"],
                        help="adafactor: factored second moments, the "
                             "memory budget of the reference's 8-bit Adam")
    parser.add_argument("--max_grad_norm", type=float, default=None,
                        help="global-norm gradient clipping (off by default, "
                             "matching the reference runner)")
    parser.add_argument("--task", type=str, default="sft",
                        choices=["sft", "sft:data_process", "sft:train",
                                 "direct_distill",
                                 "direct_distill:data_process",
                                 "direct_distill:train"])
    parser.add_argument("--distill_steps", type=int, default=4,
                        help="student inference steps for direct_distill")
    parser.add_argument("--fsdp", default=False, action="store_true",
                        help="ZeRO-3-style weight+optimizer sharding over "
                             "the data mesh axis")
    return parser


def add_output_config(parser):
    parser.add_argument("--output_path", type=str, default="./models")
    parser.add_argument("--remove_prefix_in_ckpt", type=str, default="pipe.dit.")
    parser.add_argument("--save_steps", type=int, default=None)
    parser.add_argument("--preemption_checkpoint", type=str, default=None,
                        help="full-train-state path saved on SIGTERM/SIGINT "
                             "(resume with --resume_from)")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="train-state checkpoint (save_train_state) to "
                             "resume from")
    parser.add_argument("--async_checkpoint", default=False, action="store_true",
                        help="write step/epoch checkpoints on a background "
                             "thread so the disk write doesn't stall training")
    return parser


def add_lora_config(parser):
    parser.add_argument("--lora_base_model", type=str, default=None)
    parser.add_argument("--lora_target_modules", type=str, default="q,k,v,o,ffn.0,ffn.2")
    parser.add_argument("--lora_rank", type=int, default=32)
    parser.add_argument("--lora_checkpoint", type=str, default=None,
                        help="Stage-1 checkpoint; enables stage-2 (frozen A1/B1 + B2).")
    return parser


def add_gradient_config(parser):
    # on by default with --no-... to opt out: full-size video training needs
    # it (the reference defaults False, parsers.py:58, but its stage
    # scripts always pass the flag)
    parser.add_argument("--use_gradient_checkpointing", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument(
        "--use_gradient_checkpointing_offload", action="store_true",
        help="Park each block's remat carry in pinned host memory (the "
        "reference's save_on_cpu() variant, gradient_checkpoint.py:10-34; "
        "same flag name, trainers/utils.py:164): frees ~L*B*S*D*2 bytes "
        "of device memory.")
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    return parser


def add_mesh_config(parser):
    parser.add_argument("--mesh_data", type=int, default=-1,
                        help="Data-parallel axis size (-1 = all remaining devices).")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="Ulysses sequence-parallel axis size.")
    parser.add_argument("--mesh_pipe", type=int, default=1,
                        help="Pipeline-parallel stage count (GPipe over the "
                             "DiT block stack; outermost mesh axis).")
    parser.add_argument("--pp_microbatches", type=int, default=None,
                        help="Microbatch count for the pipeline schedule "
                             "(default: the batch size).")
    return parser


def add_general_config(parser):
    for fn in (add_dataset_base_config, add_model_config, add_training_config,
               add_output_config, add_lora_config, add_gradient_config,
               add_mesh_config):
        parser = fn(parser)
    return parser
