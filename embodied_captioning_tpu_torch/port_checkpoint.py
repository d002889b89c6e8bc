"""Port a real pretrained checkpoint into the framework in one command, on
the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/port_checkpoint.py`, with
its arguments (and `--device`) and its JSON line. Writes a
self-contained ported directory (`tools.port.save_ported`: params.pkl,
config.json and the tokenizer artifact; the JAX package's format), then
runs a smoke inference:

- coca: greedy captioning of `--image` (zeros where none is given), then
  the plain-torch replica of CoCa (`tools.torch_replica`) loaded from the
  same state dict, teacher-forced beside the port's captioner on the
  smoke image and caption; fails unless their logits correlate above
  0.999.
- sbert: the sentence embedding of `--sentence`; with `--hf-dir` (and
  `transformers` importable) also its cosine against the HF model's
  mean-pooled embedding, which must exceed 0.999.

Usage:
  python -m embodied_captioning_tpu_torch.port_checkpoint coca \
      --checkpoint open_clip_pytorch_model.bin \
      --tokenizer bpe_simple_vocab_16e6.txt.gz --out ported_coca \
      [--image photo.npy] [--max-caption-len 30] [--allow-pickle] \
      [--device cpu]
  python -m embodied_captioning_tpu_torch.port_checkpoint sbert \
      --checkpoint pytorch_model.bin --tokenizer vocab.txt \
      --out ported_sbert [--sentence "a red couch"] [--hf-dir DIR]

Prints one JSON line: kind, out_dir, config, and the smoke results
(coca: smoke_caption, smoke_tokens, parity; sbert: smoke_embedding_norm,
smoke_embedding_head, parity_cosine_vs_torch with --hf-dir).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _coca(args, dev, out: dict) -> None:
    from .models import captioner as CAP
    from .params import from_jax
    from .tools import port as P
    from .tools.convert_weights import load_torch_checkpoint
    from .tools.torch_replica import coca_parity_report

    state = load_torch_checkpoint(args.checkpoint,
                                  allow_pickle=args.allow_pickle)
    params, cfg, tok = P.port_coca_state(state, args.tokenizer,
                                         args.max_caption_len)
    P.save_ported(args.out, params, cfg, args.tokenizer, "coca")
    out["config"] = {
        "vision_width": cfg.vision.width, "vision_layers": cfg.vision.layers,
        "image_size": cfg.vision.image_size, "vocab": cfg.text.vocab_size,
        "text_layers": cfg.text.layers, "mm_blocks": cfg.text.cross_layers,
        "bos": cfg.text.bos_id, "eos": cfg.text.eos_id}
    if args.image:
        img = np.load(args.image)
    else:
        img = np.zeros((cfg.vision.image_size, cfg.vision.image_size, 3),
                       np.uint8)
    tparams = from_jax(params, dev)
    del params
    toks, _, lengths = CAP.generate(
        tparams, torch.from_numpy(np.asarray(img, np.uint8))[None].to(dev),
        cfg)
    toks = toks.cpu().numpy()
    out["smoke_caption"] = tok.decode(toks[0])
    out["smoke_tokens"] = int(lengths[0])
    # teacher-forced on the generated prefix, at least BOS and one token
    # (generation may stop after one token on a blank image)
    probe = toks[:, : max(2, int(lengths[0]))]
    out["parity"] = coca_parity_report(state, tparams, cfg, img[None], probe,
                                       dev)
    if not out["parity"]["teacher_forced_corr"] > 0.999:
        raise AssertionError(f"parity failed: {out['parity']}")


def _sbert(args, dev, out: dict) -> None:
    from .models import sbert as SB
    from .params import from_jax
    from .tools import port as P

    params, cfg, tok = P.port_sbert(args.checkpoint, args.tokenizer,
                                    allow_pickle=args.allow_pickle)
    P.save_ported(args.out, params, cfg, args.tokenizer, "sbert")
    out["config"] = {"width": cfg.width, "layers": cfg.layers,
                     "vocab": cfg.vocab_size, "post_ln": cfg.post_ln}
    ids = tok.encode_batch([args.sentence], cfg.max_len)
    emb = SB.encode_tokens(from_jax(params, dev),
                           torch.from_numpy(ids).to(dev), cfg).cpu().numpy()
    out["smoke_embedding_norm"] = float(np.linalg.norm(emb[0]))
    out["smoke_embedding_head"] = [round(float(x), 5) for x in emb[0, :4]]
    if args.hf_dir:
        from transformers import AutoModel, AutoTokenizer

        hf_tok = AutoTokenizer.from_pretrained(args.hf_dir)
        hf = AutoModel.from_pretrained(args.hf_dir).eval()
        batch = hf_tok([args.sentence], return_tensors="pt", padding=True,
                       truncation=True, max_length=cfg.max_len)
        with torch.no_grad():
            h = hf(**batch).last_hidden_state
        m = batch["attention_mask"][..., None].float()
        ref = ((h * m).sum(1) / m.sum(1)).numpy()
        ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
        cos = float((emb[0] * ref[0]).sum())
        out["parity_cosine_vs_torch"] = round(cos, 6)
        if not cos > 0.999:
            raise AssertionError(f"parity failed: cosine {cos}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["coca", "sbert"])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--tokenizer", required=True,
                    help="bpe_simple_vocab_16e6.txt.gz (coca) / vocab.txt "
                         "(sbert)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--allow-pickle", action="store_true",
                    help="permit non-weights_only torch.load (trusted files "
                         "only: unpickling executes code)")
    ap.add_argument("--image", default=None,
                    help="npy [H,W,3] uint8 to caption (coca smoke)")
    ap.add_argument("--sentence", default="a red couch in the living room",
                    help="sentence to embed (sbert smoke)")
    ap.add_argument("--max-caption-len", type=int, default=30)
    ap.add_argument("--hf-dir", default=None,
                    help="HF model dir for the sbert torch parity check")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("port_checkpoint: no CUDA device (pass --device "
                           "cpu to run on the CPU)")
    out = {"kind": args.kind, "out_dir": args.out}
    (_coca if args.kind == "coca" else _sbert)(args, dev, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
