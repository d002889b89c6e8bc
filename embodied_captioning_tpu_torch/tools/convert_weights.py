"""Torch checkpoints -> numpy parameter trees, once, at porting time.

open_clip's CoCa and HF's MiniLM / BERT state dicts map onto the
captioner's and the sentence encoder's trees: dense kernels [in, out],
LayerNorms {g, b}, torch's packed in_proj split into q / k / v. The trees
are the JAX package's converters' trees leaf for leaf (numpy, float32 as
the checkpoint holds them), so a ported directory loads in either package;
`params.from_jax` carries a tree to a device.

  convert_clip_vit      open_clip ViT (conv1 patch embed, class_embedding,
                        positional_embedding, resblocks) -> models/vit.py
  convert_attn_pool     open_clip AttentionalPooler -> the CoCa pooler
  convert_bert_encoder  HF BERT / MiniLM encoder -> models/sbert.py
  convert_gpt_decoder   open_clip text tower -> the captioner's text tower
  convert_coca_multimodal, convert_coca   the whole CoCa captioner
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dense_from_linear(weight, bias) -> Dict[str, np.ndarray]:
    """torch nn.Linear stores [out, in]; our dense is [in, out]."""
    return {"w": _t(weight).T.copy(), "b": _t(bias).copy()}


def _ln(weight, bias) -> Dict[str, np.ndarray]:
    return {"g": _t(weight).copy(), "b": _t(bias).copy()}


def _mha_from_in_proj(in_proj_w, in_proj_b, out_w, out_b, dim: int
                      ) -> Dict[str, Any]:
    """torch nn.MultiheadAttention packs QKV into in_proj [3*dim, dim]."""
    w = _t(in_proj_w)
    b = _t(in_proj_b)
    return {
        "q": {"w": w[:dim].T.copy(), "b": b[:dim].copy()},
        "k": {"w": w[dim:2 * dim].T.copy(), "b": b[dim:2 * dim].copy()},
        "v": {"w": w[2 * dim:].T.copy(), "b": b[2 * dim:].copy()},
        "o": _dense_from_linear(out_w, out_b),
    }


def convert_clip_vit(state: Mapping[str, Any], prefix: str = "visual."
                     ) -> Dict[str, Any]:
    """open_clip VisionTransformer state dict -> models/vit.py params.

    Expected keys (open_clip naming): `conv1.weight` [width, 3, p, p],
    `class_embedding`, `positional_embedding`, `ln_pre`, `ln_post`,
    `transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}`.
    The backbone (patch embed -> blocks -> ln_post) converts exactly.
    open_clip CoCa's `attn_pool` converts separately via
    `convert_attn_pool` (the forward switches to the CoCa-exact
    LN-before-attention ordering when those params are present).
    """
    sd = {k[len(prefix):]: v for k, v in state.items()
          if k.startswith(prefix)}
    conv = _t(sd["conv1.weight"])  # [width, 3, p, p]
    width = conv.shape[0]
    # our patch embed consumes patchify() layout: (p, p, 3) flattened
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, width).copy()
    params: Dict[str, Any] = {
        "patch": {"w": patch_w, "b": np.zeros(width, np.float32)},
        "cls": _t(sd["class_embedding"]).copy(),
        "ln_pre": _ln(sd["ln_pre.weight"], sd["ln_pre.bias"]),
        "ln_post": _ln(sd["ln_post.weight"], sd["ln_post.bias"]),
        "blocks": [],
    }
    pos = _t(sd["positional_embedding"])
    params["pos"] = pos.copy()
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}."
        params["blocks"].append({
            "ln1": _ln(sd[p + "ln_1.weight"], sd[p + "ln_1.bias"]),
            "attn": _mha_from_in_proj(
                sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"],
                sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"],
                width),
            "ln2": _ln(sd[p + "ln_2.weight"], sd[p + "ln_2.bias"]),
            "mlp": {
                "fc": _dense_from_linear(sd[p + "mlp.c_fc.weight"],
                                         sd[p + "mlp.c_fc.bias"]),
                "proj": _dense_from_linear(sd[p + "mlp.c_proj.weight"],
                                           sd[p + "mlp.c_proj.bias"]),
            },
        })
        i += 1
    if "proj" in sd:
        w = _t(sd["proj"])  # open_clip stores [width, embed_dim] matrix
        params["proj"] = {"w": w.copy(), "b": np.zeros(w.shape[1],
                                                       np.float32)}
    return params


def convert_attn_pool(state: Mapping[str, Any], prefix: str = "attn_pool.",
                      dim: Optional[int] = None) -> Dict[str, Any]:
    """open_clip AttentionalPooler -> models/vit.attentional_pool params
    (CoCa-exact ordering: ln_q/ln_k BEFORE attention, no output LN — the
    forward takes that path whenever `pool_ln_q` is present).

    Handles both torch MultiheadAttention layouts: packed `in_proj_weight`
    (kdim == embed_dim) and separate `q/k/v_proj_weight` (kdim != embed_dim,
    which CoCa uses when context width != pooler width).
    """
    sd = {k[len(prefix):]: v for k, v in state.items()
          if k.startswith(prefix)}
    query = _t(sd["query"]).copy()
    dim = dim or query.shape[-1]
    if "attn.in_proj_weight" in sd:
        attn = _mha_from_in_proj(
            sd["attn.in_proj_weight"], sd["attn.in_proj_bias"],
            sd["attn.out_proj.weight"], sd["attn.out_proj.bias"], dim)
    else:
        b = _t(sd["attn.in_proj_bias"])
        attn = {
            "q": {"w": _t(sd["attn.q_proj_weight"]).T.copy(),
                  "b": b[:dim].copy()},
            "k": {"w": _t(sd["attn.k_proj_weight"]).T.copy(),
                  "b": b[dim:2 * dim].copy()},
            "v": {"w": _t(sd["attn.v_proj_weight"]).T.copy(),
                  "b": b[2 * dim:].copy()},
            "o": _dense_from_linear(sd["attn.out_proj.weight"],
                                    sd["attn.out_proj.bias"]),
        }
    return {
        "pool_q": query,
        "pool_attn": attn,
        "pool_ln_q": _ln(sd["ln_q.weight"], sd["ln_q.bias"]),
        "pool_ln_k": _ln(sd["ln_k.weight"], sd["ln_k.bias"]),
    }


def convert_bert_encoder(state: Mapping[str, Any], prefix: str = ""
                         ) -> Dict[str, Any]:
    """HF BERT/MiniLM encoder state dict -> models/sbert.py params.

    Keys: `embeddings.word_embeddings.weight`,
    `embeddings.position_embeddings.weight`,
    `embeddings.token_type_embeddings.weight`, `embeddings.LayerNorm`,
    `encoder.layer.{i}.attention.self.{query,key,value}`,
    `encoder.layer.{i}.attention.output.dense` + `LayerNorm`,
    `encoder.layer.{i}.intermediate.dense`, `encoder.layer.{i}.output.dense`
    + `LayerNorm`.

    The output is EXACT for the post-LN encoder (`SentenceEncoderConfig(
    post_ln=True)` / models/common.block_post_ln): ln1 <- attention.output.
    LayerNorm, ln2 <- output.LayerNorm, emb_ln <- embeddings.LayerNorm, and
    token-type embedding row 0 (single-segment sentence encoding) is folded
    into pos_emb. Loading these params into a pre-LN encoder
    (post_ln=False) computes a DIFFERENT function — do not.
    """
    sd = {k[len(prefix):]: v for k, v in state.items()
          if k.startswith(prefix)}
    pos_emb = _t(sd["embeddings.position_embeddings.weight"]).copy()
    if "embeddings.token_type_embeddings.weight" in sd:
        # single-segment inputs use token type 0 everywhere: a constant
        # additive row, folded into the (per-position) position embeddings
        pos_emb = pos_emb + _t(sd["embeddings.token_type_embeddings.weight"])[0]
    params: Dict[str, Any] = {
        "tok_emb": _t(sd["embeddings.word_embeddings.weight"]).copy(),
        "pos_emb": pos_emb,
        "blocks": [],
    }
    if "embeddings.LayerNorm.weight" in sd:
        params["emb_ln"] = _ln(sd["embeddings.LayerNorm.weight"],
                               sd["embeddings.LayerNorm.bias"])
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"encoder.layer.{i}."
        params["blocks"].append({
            "ln1": _ln(sd[p + "attention.output.LayerNorm.weight"],
                       sd[p + "attention.output.LayerNorm.bias"]),
            "attn": {
                "q": _dense_from_linear(
                    sd[p + "attention.self.query.weight"],
                    sd[p + "attention.self.query.bias"]),
                "k": _dense_from_linear(
                    sd[p + "attention.self.key.weight"],
                    sd[p + "attention.self.key.bias"]),
                "v": _dense_from_linear(
                    sd[p + "attention.self.value.weight"],
                    sd[p + "attention.self.value.bias"]),
                "o": _dense_from_linear(
                    sd[p + "attention.output.dense.weight"],
                    sd[p + "attention.output.dense.bias"]),
            },
            "ln2": _ln(sd[p + "output.LayerNorm.weight"],
                       sd[p + "output.LayerNorm.bias"]),
            "mlp": {
                "fc": _dense_from_linear(sd[p + "intermediate.dense.weight"],
                                         sd[p + "intermediate.dense.bias"]),
                "proj": _dense_from_linear(sd[p + "output.dense.weight"],
                                           sd[p + "output.dense.bias"]),
            },
        })
        i += 1
    dim = params["tok_emb"].shape[1]
    params["ln"] = {"g": np.ones(dim, np.float32),
                    "b": np.zeros(dim, np.float32)}
    params["proj"] = {"w": np.eye(dim, dtype=np.float32),
                      "b": np.zeros(dim, np.float32)}
    return params


def convert_gpt_decoder(state: Mapping[str, Any], dim: int,
                        prefix: str = "") -> Dict[str, Any]:
    """GPT/open_clip-text-style causal decoder (ln_1/attn/ln_2/mlp resblocks
    + token_embedding + positional_embedding) -> captioner text-tower params
    fragment {tok_emb, pos_emb, text_blocks, ln_text}."""
    sd = {k[len(prefix):]: v for k, v in state.items()
          if k.startswith(prefix)}
    out: Dict[str, Any] = {
        "tok_emb": _t(sd["token_embedding.weight"]).copy(),
        "pos_emb": _t(sd["positional_embedding"]).copy(),
        "text_blocks": [],
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}."
        out["text_blocks"].append({
            "ln1": _ln(sd[p + "ln_1.weight"], sd[p + "ln_1.bias"]),
            "attn": _mha_from_in_proj(
                sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"],
                sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"],
                dim),
            "ln2": _ln(sd[p + "ln_2.weight"], sd[p + "ln_2.bias"]),
            "mlp": {
                "fc": _dense_from_linear(sd[p + "mlp.c_fc.weight"],
                                         sd[p + "mlp.c_fc.bias"]),
                "proj": _dense_from_linear(sd[p + "mlp.c_proj.weight"],
                                           sd[p + "mlp.c_proj.bias"]),
            },
        })
        i += 1
    if "ln_final.weight" in sd:
        out["ln_text"] = _ln(sd["ln_final.weight"], sd["ln_final.bias"])
    return out


def convert_coca_multimodal(state: Mapping[str, Any],
                            prefix: str = "text_decoder.", dim: int = 768
                            ) -> Dict[str, Any]:
    """open_clip MultimodalTransformer -> captioner fragment
    {mm_blocks, ln_mm, head}.

    open_clip interleaves a SELF-attention ResidualAttentionBlock
    (`resblocks.{i}`) with a CROSS-attention one (`cross_attn.{i}`, whose KV
    input is normalized by `ln_1_kv`); each has its own MLP. The fragment
    maps layer i to TWO of our blocks — a self-only block (no "xattn") and
    a cross-only block (no "attn") — which models/common.block dispatches
    on by key presence, reproducing the torch forward exactly. The vocab
    projection is `text_projection` [width, vocab] (no bias) after
    `ln_final` -> our head after ln_mm."""
    sd = {k[len(prefix):]: v for k, v in state.items()
          if k.startswith(prefix)}
    mm_blocks = []
    i = 0
    while f"resblocks.{i}.ln_1.weight" in sd:
        p = f"resblocks.{i}."
        mm_blocks.append({
            "ln1": _ln(sd[p + "ln_1.weight"], sd[p + "ln_1.bias"]),
            "attn": _mha_from_in_proj(
                sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"],
                sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"],
                dim),
            "ln2": _ln(sd[p + "ln_2.weight"], sd[p + "ln_2.bias"]),
            "mlp": {
                "fc": _dense_from_linear(sd[p + "mlp.c_fc.weight"],
                                         sd[p + "mlp.c_fc.bias"]),
                "proj": _dense_from_linear(sd[p + "mlp.c_proj.weight"],
                                           sd[p + "mlp.c_proj.bias"]),
            },
        })
        c = f"cross_attn.{i}."
        mm_blocks.append({
            "ln_x": _ln(sd[c + "ln_1.weight"], sd[c + "ln_1.bias"]),
            "ln_kv": _ln(sd[c + "ln_1_kv.weight"], sd[c + "ln_1_kv.bias"]),
            "xattn": _mha_from_in_proj(
                sd[c + "attn.in_proj_weight"], sd[c + "attn.in_proj_bias"],
                sd[c + "attn.out_proj.weight"], sd[c + "attn.out_proj.bias"],
                dim),
            "ln2": _ln(sd[c + "ln_2.weight"], sd[c + "ln_2.bias"]),
            "mlp": {
                "fc": _dense_from_linear(sd[c + "mlp.c_fc.weight"],
                                         sd[c + "mlp.c_fc.bias"]),
                "proj": _dense_from_linear(sd[c + "mlp.c_proj.weight"],
                                           sd[c + "mlp.c_proj.bias"]),
            },
        })
        i += 1
    w = _t(sd["text_projection"])  # [width, vocab], parameter matrix
    return {
        "mm_blocks": mm_blocks,
        "ln_mm": _ln(sd["ln_final.weight"], sd["ln_final.bias"]),
        "head": {"w": w.copy(), "b": np.zeros(w.shape[1], np.float32)},
    }


def convert_coca(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Full open_clip CoCa checkpoint -> captioner param pytree.

    Assembles: visual tower (convert_clip_vit + CoCa-exact attn_pool; the
    forward switches to open_clip's pool->ln_post->split ordering when the
    pooler params are present — models/vit.encode_image), unimodal text
    tower (convert_gpt_decoder on `text.`), interleaved multimodal decoder
    (`text_decoder.`), logit_scale. The text tower's trailing cls token
    (open_clip embed_cls) does not affect caption-token features under the
    causal mask, so captions port exactly; the contrastive text latent uses
    our EOS-position pooling instead of the cls token (approximate —
    documented).

    Use with `TextDecoderConfig(pad_id=0, bos_id=49406, eos_id=49407,
    layers=<n self>, cross_layers=<2n interleaved>)` and the CLIP BPE
    tokenizer (models/tokenizer_artifacts.CLIPBPETokenizer);
    `port_checkpoint` builds all of that in one command."""
    width = _t(state["text.token_embedding.weight"]).shape[1]
    params: Dict[str, Any] = {
        "vision": convert_clip_vit(state, "visual."),
    }
    params["vision"].update(convert_attn_pool(state, "visual.attn_pool.",
                                              dim=width))
    if "proj" not in params["vision"]:  # pool width == embed dim: identity
        params["vision"]["proj"] = {"w": np.eye(width, dtype=np.float32),
                                    "b": np.zeros(width, np.float32)}
    params.update(convert_gpt_decoder(state, width, prefix="text."))
    params.update(convert_coca_multimodal(state, "text_decoder.", width))
    if "text.text_projection" in state:
        tp = _t(state["text.text_projection"])
        params["text_proj"] = {"w": tp.copy(),
                               "b": np.zeros(tp.shape[1], np.float32)}
    params["logit_scale"] = np.asarray(_t(state["logit_scale"]), np.float32)
    return params


def load_torch_checkpoint(path: str, allow_pickle: bool = False
                          ) -> Dict[str, Any]:
    """Load a torch checkpoint safely.

    Defaults to `weights_only=True` (tensors only — no arbitrary unpickling).
    Third-party checkpoints that need full pickle must opt in explicitly
    with `allow_pickle=True`, since unpickling executes arbitrary code.
    A `state_dict` entry is unwrapped and DataParallel's "module." prefixes
    stripped.
    """
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True; pass "
                "allow_pickle=True ONLY if you trust this file (unpickling "
                "executes arbitrary code)") from exc
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v for k, v in obj.items()}
