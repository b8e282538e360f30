"""Merge the stage-1 identity and stage-2 motion adapters: keep A1,
B = B1 + B2 (the twin of examples/merge_weights.py).

Usage:
  python -m fairygen_tpu_torch.examples.merge_weights \\
      --stage1 stage1/epoch-0.safetensors --stage2 stage2/epoch-0.safetensors \\
      --output merged.safetensors
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stage1", type=str, required=True)
    p.add_argument("--stage2", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)

    from fairygen_tpu_torch.core.io import load_state_dict, save_safetensors
    from fairygen_tpu_torch.models.adapters import merge_stage_weights

    merged = merge_stage_weights(load_state_dict(args.stage1), load_state_dict(args.stage2))
    save_safetensors(args.output, merged)
    print(f"merged {len(merged)} tensors -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
