"""One-time offline conversion: Meta torch checkpoint -> the port's
checkpoint directory (``params.pt``, ``config.json``, ``manifest.json``):

    python -m jax_llama_tpu_torch.convert \
        --ckpt-dir /path/to/Meta-Llama-3-8B \
        --tokenizer /path/to/tokenizer.model \
        --out-dir /path/to/llama3-8b-torch \
        [--max-seq-len 8192] [--dtype bfloat16] [--device cuda]

The flags are the JAX package's (``python -m jax_llama_tpu.convert``);
``--device`` (default "cuda") is where the weights are laid out before
they are written.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True,
                    help="directory with consolidated.*.pth + params.json")
    ap.add_argument("--tokenizer", required=True,
                    help="tokenizer.model path (tiktoken ranks for llama3, "
                         "sentencepiece for llama2)")
    ap.add_argument("--llama2", action="store_true",
                    help="use the sentencepiece (llama2) tokenizer")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "float16"])
    ap.add_argument("--device", default="cuda",
                    help="where the weights are laid out ('cuda' or 'cpu')")
    args = ap.parse_args()

    from . import convert_meta_checkpoint, save_checkpoint

    if args.llama2:
        from ..tokenizers import LLaMA2Tokenizer as Tok
    else:
        from ..tokenizers import LLaMA3Tokenizer as Tok
    tokenizer = Tok(args.tokenizer)

    params, config = convert_meta_checkpoint(
        args.ckpt_dir, tokenizer,
        max_seq_len=args.max_seq_len, dtype=args.dtype, device=args.device,
    )
    save_checkpoint(args.out_dir, params, config)
    print(f"wrote {args.out_dir}: {config}")


if __name__ == "__main__":
    main()
