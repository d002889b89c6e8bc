"""A plain-torch replica of open_clip's CoCa, to hold a ported checkpoint
against: the CoCa computation (conv1 patch embed, pre-LN resblocks, the
attentional pooler in the pool -> ln_post -> split ordering, the unimodal
text tower, the multimodal decoder of self-attention and cross-attention
blocks with ln_1_kv) rebuilt at the dimensions read from a state dict's
own shapes, loaded from it, and run teacher-forced beside the port's
captioner (`coca_parity_report`). No open_clip needed, so the comparison
runs for any checkpoint in this layout, tiny fixtures and
coca_ViT-L-14 alike, on the device the caller names.

Keys the replica does not model (open_clip's contrastive-only
`text.cls_emb`, for one) are reported, not dropped in silence.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def zero_state(v_width: int, t_width: int, v_layers: int, t_layers: int,
               mm_pairs: int, patch: int, image: int, queries: int,
               vocab: int, ctx: int, mlp: int = 4) -> Dict[str, Any]:
    """A state dict of zeros holding just the keys and shapes that
    `build_torch_coca` reads: a replica built on it and given weights is
    a CoCa checkpoint of those dimensions (`mlp`: the MLP's width over the
    tower's)."""
    z = torch.zeros
    return {
        "visual.conv1.weight": z(v_width, 3, patch, patch),
        "visual.positional_embedding": z((image // patch) ** 2 + 1, v_width),
        "visual.ln_post.weight": z(t_width),
        "visual.attn_pool.query": z(queries, t_width),
        "text.token_embedding.weight": z(vocab, t_width),
        "text.positional_embedding": z(ctx, t_width),
        "visual.transformer.resblocks.0.mlp.c_fc.weight":
            z(mlp * v_width, v_width),
        "text.transformer.resblocks.0.mlp.c_fc.weight":
            z(mlp * t_width, t_width),
        **{f"visual.transformer.resblocks.{i}.ln_1.weight": z(v_width)
           for i in range(v_layers)},
        **{f"text.transformer.resblocks.{i}.ln_1.weight": z(t_width)
           for i in range(t_layers)},
        **{f"text_decoder.resblocks.{i}.ln_1.weight": z(t_width)
           for i in range(mm_pairs)},
    }


def build_torch_coca(state: Mapping[str, Any], device="cpu"):
    """state dict -> (torch replica module in eval mode on `device`, load
    report dict).

    Dimensions (widths, depths, patch, queries, vocab, context) are read
    from the state-dict shapes, as `port.infer_coca_config` reads them:
    width / 64 heads in the towers, text width / 96 in the pooler
    (open_clip's 8 at 768). Vision and text widths may differ (real CoCa:
    ViT-L 1024 vision / 768 text); the attentional pooler then uses
    torch's separate q/k/v_proj_weight MHA layout exactly like open_clip.
    """

    def shp(k):
        return tuple(state[k].shape)

    v_width, _, patch, _ = shp("visual.conv1.weight")
    queries, t_width = shp("visual.attn_pool.query")
    vocab, t_width2 = shp("text.token_embedding.weight")
    assert t_width2 == t_width, (t_width, t_width2)
    ctx = shp("text.positional_embedding")[0]
    ln_post_dim = shp("visual.ln_post.weight")[0]
    if ln_post_dim != t_width:
        raise ValueError(
            f"visual.ln_post dim {ln_post_dim} != pooled width {t_width}: "
            "checkpoint uses an ln_post-before-pool ordering the converter "
            "does not model")

    def count(fmt):
        i = 0
        while fmt.format(i) in state:
            i += 1
        return i

    v_layers = count("visual.transformer.resblocks.{}.ln_1.weight")
    t_layers = count("text.transformer.resblocks.{}.ln_1.weight")
    mm_pairs = count("text_decoder.resblocks.{}.ln_1.weight")
    v_heads = max(1, v_width // 64)
    t_heads = max(1, t_width // 64)
    pool_heads = max(1, t_width // 96)
    v_mlp = shp("visual.transformer.resblocks.0.mlp.c_fc.weight")[0]
    t_mlp = shp("text.transformer.resblocks.0.mlp.c_fc.weight")[0]

    def causal(t):
        return torch.triu(torch.full((t, t), float("-inf"), device=device),
                          diagonal=1)

    class Block(nn.Module):
        def __init__(self, width, heads, mlp_dim, cross=False):
            super().__init__()
            self.ln_1 = nn.LayerNorm(width)
            if cross:
                self.ln_1_kv = nn.LayerNorm(width)
            self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
            self.ln_2 = nn.LayerNorm(width)
            self.mlp = nn.Sequential()
            self.mlp.c_fc = nn.Linear(width, mlp_dim)
            self.mlp.c_proj = nn.Linear(mlp_dim, width)
            self.cross = cross

        def forward(self, x, kv=None, mask=None):
            h = self.ln_1(x)
            if self.cross:
                k = self.ln_1_kv(kv)
                a, _ = self.attn(h, k, k, need_weights=False)
            else:
                a, _ = self.attn(h, h, h, attn_mask=mask, need_weights=False)
            x = x + a
            h = self.ln_2(x)
            return x + self.mlp.c_proj(
                torch.nn.functional.gelu(self.mlp.c_fc(h)))

    class AttnPool(nn.Module):
        def __init__(self):
            super().__init__()
            self.query = nn.Parameter(torch.randn(queries, t_width) * 0.2)
            # kdim/vdim = vision width: torch stores separate
            # q/k/v_proj_weight exactly when kdim != embed_dim — the
            # open_clip layout convert_attn_pool's second branch reads
            self.attn = nn.MultiheadAttention(
                t_width, pool_heads, batch_first=True,
                kdim=v_width, vdim=v_width)
            self.ln_q = nn.LayerNorm(t_width)
            self.ln_k = nn.LayerNorm(v_width)

        def forward(self, x):
            q = self.ln_q(self.query)[None].expand(x.shape[0], -1, -1)
            k = self.ln_k(x)
            out, _ = self.attn(q, k, k, need_weights=False)
            return out

    class Coca(nn.Module):
        def __init__(self):
            super().__init__()
            grid = int(round((shp("visual.positional_embedding")[0] - 1)
                             ** 0.5))
            self.grid = grid
            v = nn.Module()
            v.conv1 = nn.Conv2d(3, v_width, patch, patch, bias=False)
            v.class_embedding = nn.Parameter(torch.randn(v_width) * 0.02)
            v.positional_embedding = nn.Parameter(
                torch.randn(grid * grid + 1, v_width) * 0.02)
            v.ln_pre = nn.LayerNorm(v_width)
            v.transformer = nn.Module()
            v.transformer.resblocks = nn.ModuleList(
                [Block(v_width, v_heads, v_mlp) for _ in range(v_layers)])
            v.ln_post = nn.LayerNorm(t_width)
            v.attn_pool = AttnPool()
            self.visual = v
            t = nn.Module()
            t.token_embedding = nn.Embedding(vocab, t_width)
            t.positional_embedding = nn.Parameter(
                torch.randn(ctx, t_width) * 0.02)
            t.transformer = nn.Module()
            t.transformer.resblocks = nn.ModuleList(
                [Block(t_width, t_heads, t_mlp) for _ in range(t_layers)])
            t.ln_final = nn.LayerNorm(t_width)
            # real CoCa always carries a contrastive text projection
            tp_shape = (shp("text.text_projection")
                        if "text.text_projection" in state
                        else (t_width, t_width))
            t.text_projection = nn.Parameter(torch.randn(*tp_shape) * 0.1)
            self.text = t
            d = nn.Module()
            d.resblocks = nn.ModuleList(
                [Block(t_width, t_heads, t_mlp) for _ in range(mm_pairs)])
            d.cross_attn = nn.ModuleList(
                [Block(t_width, t_heads, t_mlp, cross=True)
                 for _ in range(mm_pairs)])
            d.ln_final = nn.LayerNorm(t_width)
            d.text_projection = nn.Parameter(
                torch.randn(t_width, vocab) * 0.1)
            self.text_decoder = d
            self.logit_scale = nn.Parameter(torch.tensor(2.0))
            if "visual.proj" in state:
                self.visual.proj = nn.Parameter(
                    torch.randn(*shp("visual.proj")) * 0.1)

        def encode_image(self, x):
            v = self.visual
            x = v.conv1(x).flatten(2).transpose(1, 2)
            cls = v.class_embedding[None, None].expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], 1) + v.positional_embedding
            x = v.ln_pre(x)
            for blk in v.transformer.resblocks:
                x = blk(x, mask=None)
            x = v.attn_pool(x)          # pool BEFORE ln_post (CoCa branch)
            x = v.ln_post(x)
            return x[:, 0], x[:, 1:]    # latent, decoder tokens

        def forward(self, img, toks):
            _, img_tokens = self.encode_image(img)
            t = self.text
            n = toks.shape[1]
            x = t.token_embedding(toks) + t.positional_embedding[:n]
            m = causal(n)
            for blk in t.transformer.resblocks:
                x = blk(x, mask=m)
            x = t.ln_final(x)
            d = self.text_decoder
            for sb, cb in zip(d.resblocks, d.cross_attn):
                x = sb(x, mask=m)
                x = cb(x, kv=img_tokens)
            return d.ln_final(x) @ d.text_projection

    with torch.device(device):   # random init on the device, then load
        model = Coca().eval()
    tensors = {k: torch.as_tensor(v) for k, v in state.items()
               if hasattr(v, "shape")}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    report = {
        "replica_missing": sorted(missing),
        "checkpoint_unconsumed": sorted(unexpected),
        "vision": {"width": v_width, "layers": v_layers, "patch": patch},
        "text": {"width": t_width, "layers": t_layers,
                 "mm_pairs": mm_pairs, "vocab": vocab, "ctx": ctx},
    }
    return model, report


def coca_parity_report(state: Mapping[str, Any], params: dict, cfg,
                       img_u8: np.ndarray, toks: np.ndarray,
                       device="cpu") -> Dict[str, Any]:
    """Teacher-forced logits of the replica (loaded from the checkpoint,
    float32 with TF32 off) against the port's captioner (`params`: the
    converted tree's tensors on `device`) on the same CLIP-normalised
    pixels and token prefixes: their correlation, argmax agreement and
    largest difference over the replica's spread. The replica is freed
    before the report returns."""
    from ..models import captioner as CAP
    from ..ops.image import CLIP_MEAN, CLIP_STD

    imf = np.asarray(img_u8, np.float32) / 255.0
    imf = ((imf - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
           ).astype(np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model, report = build_torch_coca(state, device)
        with torch.no_grad():
            ref = model(
                torch.from_numpy(imf.transpose(0, 3, 1, 2)).to(device),
                torch.from_numpy(np.asarray(toks, np.int64)).to(device)
            ).float().cpu().numpy()
        del model
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    with torch.no_grad():
        ours, _, _ = CAP.forward(
            params, torch.from_numpy(np.asarray(img_u8, np.uint8)).to(device),
            torch.from_numpy(np.asarray(toks, np.int32)).to(device), cfg)
    ours = ours.float().cpu().numpy()
    corr = float(np.corrcoef(ours.ravel(), ref.ravel())[0, 1])
    agree = float((ours.argmax(-1) == ref.argmax(-1)).mean())
    report.update({
        "teacher_forced_corr": round(corr, 6),
        "argmax_agreement": round(agree, 4),
        "max_abs_delta_over_std": round(
            float(np.abs(ours - ref).max() / max(ref.std(), 1e-9)), 4),
    })
    return report
