"""Turnkey real-checkpoint porting: a torch checkpoint and its tokenizer
artifact -> (numpy parameter tree, config, tokenizer), the model's
dimensions inferred from the state dict's shapes, so no architecture
flags are needed (open_clip's `coca_ViT-L-14` and sentence-transformers'
`all-MiniLM-L6-v2` among them).

A ported directory holds `params.pkl` (the numpy tree), `config.json`
({"kind", "config", "tokenizer_file"}) and the tokenizer artifact beside
them: the JAX package's format, so a directory either package writes
loads in the other. Entry point: `port_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Tuple

from ..config import (
    CaptionerConfig, SentenceEncoderConfig, TextDecoderConfig, VitConfig,
)
from ..models.tokenizer_artifacts import CLIPBPETokenizer, WordPieceTokenizer
from ..params import dump_tree, load_pickle
from .convert_weights import (
    convert_bert_encoder, convert_coca, load_torch_checkpoint,
)


def _count(state: Dict[str, Any], fmt: str) -> int:
    i = 0
    while fmt.format(i) in state:
        i += 1
    return i


def infer_coca_config(state: Dict[str, Any],
                      tokenizer: CLIPBPETokenizer,
                      max_caption_len: int = 30) -> CaptionerConfig:
    """CaptionerConfig from an open_clip CoCa state dict's shapes. Head
    counts follow open_clip's width / 64 (ViT-L 1024 / 64 = 16, text
    768 / 64 = 12); the pooler's, text width / 96 (open_clip's 8)."""
    v_width, _, patch, _ = tuple(state["visual.conv1.weight"].shape)
    grid = int(round((state["visual.positional_embedding"].shape[0] - 1)
                     ** 0.5))
    queries = state["visual.attn_pool.query"].shape[0]
    vocab, t_width = tuple(state["text.token_embedding.weight"].shape)
    ctx = state["text.positional_embedding"].shape[0]
    v_layers = _count(state, "visual.transformer.resblocks.{}.ln_1.weight")
    t_layers = _count(state, "text.transformer.resblocks.{}.ln_1.weight")
    mm_pairs = _count(state, "text_decoder.resblocks.{}.ln_1.weight")
    fc = state["visual.transformer.resblocks.0.mlp.c_fc.weight"]
    mlp_ratio = fc.shape[0] / v_width
    if vocab != tokenizer.vocab_size:
        raise ValueError(
            f"checkpoint vocab {vocab} != tokenizer vocab "
            f"{tokenizer.vocab_size} — wrong merges table?")
    return CaptionerConfig(
        vision=VitConfig(
            image_size=grid * patch, patch_size=patch, width=v_width,
            layers=v_layers, heads=max(1, v_width // 64),
            mlp_ratio=mlp_ratio, pool_queries=queries,
            pool_heads=max(1, t_width // 96), embed_dim=t_width),
        text=TextDecoderConfig(
            context_length=ctx, vocab_size=vocab, width=t_width,
            heads=max(1, t_width // 64), layers=t_layers,
            cross_layers=2 * mm_pairs, mlp_ratio=mlp_ratio,
            pad_id=tokenizer.pad_id, bos_id=tokenizer.bos_id,
            eos_id=tokenizer.eos_id),
        # decoding cannot outrun the positional table
        max_caption_len=min(max_caption_len, ctx),
    )


def infer_sbert_config(state: Dict[str, Any],
                       tokenizer: WordPieceTokenizer
                       ) -> SentenceEncoderConfig:
    """SentenceEncoderConfig (post-LN, float32, width / 32 heads, at most
    64 positions) from a BERT state dict's shapes."""
    vocab, width = tuple(state["embeddings.word_embeddings.weight"].shape)
    layers = _count(state, "encoder.layer.{}.attention.self.query.weight")
    max_len = min(64, state["embeddings.position_embeddings.weight"].shape[0])
    fc = state["encoder.layer.0.intermediate.dense.weight"]
    if vocab != tokenizer.vocab_size:
        raise ValueError(
            f"checkpoint vocab {vocab} != vocab.txt {tokenizer.vocab_size}")
    return SentenceEncoderConfig(
        vocab_size=vocab, width=width, layers=layers,
        heads=max(1, width // 32), mlp_ratio=fc.shape[0] / width,
        max_len=max_len, embed_dim=width, post_ln=True, dtype="float32")


def _strip_bert_prefix(state: Dict[str, Any]) -> Dict[str, Any]:
    """The bare BertModel keys of an HF layout: bare, `bert.`-prefixed or
    sentence-transformers' `0.auto_model.` wrapping."""
    for prefix in ("", "bert.", "0.auto_model."):
        if any(k.startswith(prefix + "embeddings.word_embeddings")
               for k in state):
            return {k[len(prefix):]: v for k, v in state.items()
                    if k.startswith(prefix)}
    raise ValueError("no BERT embeddings found in checkpoint")


def port_coca_state(state: Dict[str, Any], bpe_path: str,
                    max_caption_len: int = 30
                    ) -> Tuple[Dict[str, Any], CaptionerConfig,
                               CLIPBPETokenizer]:
    """`port_coca` of a loaded state dict. The merges table is sized to the
    checkpoint's own vocabulary (49,408 for real CLIP BPE)."""
    vocab = state["text.token_embedding.weight"].shape[0]
    tok = CLIPBPETokenizer.load(bpe_path, expected_vocab=int(vocab))
    cfg = infer_coca_config(state, tok, max_caption_len)
    return convert_coca(state), cfg, tok


def port_coca(checkpoint: str, bpe_path: str, allow_pickle: bool = False,
              max_caption_len: int = 30
              ) -> Tuple[Dict[str, Any], CaptionerConfig, CLIPBPETokenizer]:
    """An open_clip CoCa checkpoint and its CLIP BPE merges table ->
    (numpy captioner tree, inferred config, tokenizer)."""
    state = load_torch_checkpoint(checkpoint, allow_pickle=allow_pickle)
    return port_coca_state(state, bpe_path, max_caption_len)


def port_sbert(checkpoint: str, vocab_path: str, allow_pickle: bool = False
               ) -> Tuple[Dict[str, Any], SentenceEncoderConfig,
                          WordPieceTokenizer]:
    """An HF BERT / MiniLM checkpoint and its `vocab.txt` -> (numpy
    sentence-encoder tree, inferred config, tokenizer)."""
    state = _strip_bert_prefix(
        load_torch_checkpoint(checkpoint, allow_pickle=allow_pickle))
    tok = WordPieceTokenizer.load(vocab_path)
    cfg = infer_sbert_config(state, tok)
    return convert_bert_encoder(state), cfg, tok


def save_ported(out_dir: str, params: Dict[str, Any], cfg,
                tokenizer_src: str, kind: str) -> None:
    """A self-contained ported directory: the numpy parameter tree the
    converters return (`params.pkl`), the config (`config.json`) and the
    tokenizer artifact copied beside them."""
    os.makedirs(out_dir, exist_ok=True)
    dump_tree(params, os.path.join(out_dir, "params.pkl"))
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump({"kind": kind, "config": dataclasses.asdict(cfg),
                   "tokenizer_file": os.path.basename(tokenizer_src)}, fh,
                  indent=2)
    dst = os.path.join(out_dir, os.path.basename(tokenizer_src))
    if os.path.abspath(tokenizer_src) != os.path.abspath(dst):
        shutil.copyfile(tokenizer_src, dst)


def load_ported(out_dir: str):
    """(numpy params, config, tokenizer) from a `save_ported` directory;
    the pickle is read refusing every class outside numpy."""
    with open(os.path.join(out_dir, "config.json")) as fh:
        meta = json.load(fh)
    params = load_pickle(os.path.join(out_dir, "params.pkl"))
    tok_path = os.path.join(out_dir, meta["tokenizer_file"])
    c = meta["config"]
    if meta["kind"] == "coca":
        cfg = CaptionerConfig(
            vision=VitConfig(**c["vision"]),
            text=TextDecoderConfig(**c["text"]),
            max_caption_len=c["max_caption_len"], dtype=c["dtype"])
        tok = CLIPBPETokenizer.load(tok_path,
                                    expected_vocab=cfg.text.vocab_size)
    else:
        cfg = SentenceEncoderConfig(**c)
        tok = WordPieceTokenizer.load(tok_path)
    return params, cfg, tok
