"""The port's real-checkpoint entry points, `port_checkpoint` (coca, sbert)
and `evaluate_finetuned_model`, with `--device cpu`, against the JAX
package's scripts on the same checkpoints, annotations and directories;
the ported directory format read across the two packages; and the
refusals the JAX package makes.

Limits: configurations, trees and CSV captions equal; the sentence
embedding within 1e-6 (float32 on both sides); perplexities within 5e-2
relative (chosen log-probs out of bf16 logits within 5e-2, as
`test_torch_generate.py` holds them); the replica parity above 0.999
(the scripts' own bar). The captions are greedy decodes of random
weights, chaotic where the top two logits nearly tie (ROADMAP C.8): the
annotations' seed is one where no row parts."""

import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import CaptionerConfig as JCfg
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu.tools import port as JP
from embodied_captioning_tpu_torch import evaluate_finetuned_model as EVAL
from embodied_captioning_tpu_torch import port_checkpoint as PORT
from embodied_captioning_tpu_torch.tools import port as TP
from embodied_captioning_tpu_torch.utils.obs_store import save_obs
from chip_smoke import minilm_state
from test_torch_convert import _write_bpe, replica_state, same_tree
from torch_parity import jax_kernel_path

REPO = Path(__file__).resolve().parents[1]
# the CoCa of these tests: text 64 wide, so every decode sublayer takes
# its block kernel's twin
COCA = dict(v_width=128, t_width=64, v_layers=2, t_layers=2, mm_pairs=2,
            patch=8, image=32, queries=5, vocab=600, ctx=16)
N_MERGES = 600 - 514
ANNOTATION_SEED = 3


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, jax_side):
    """(JSON of the last line printed, return code) of an entry point:
    the JAX script through sys.argv on its block route (Pallas in
    interpret mode, the route the port's default decode mirrors), the
    port's with --device cpu."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            with jax_kernel_path(blocks=True):
                rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    return json.loads(buf.getvalue().splitlines()[-1]), rc


def vocab_lines(n):
    """A `vocab.txt` body of n tokens: BERT's specials, letters, then
    words and '##' pieces."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        chr(c) for c in range(ord("a"), ord("z") + 1)] + [
        "a", "red", "couch", "in", "the", "living", "room", "##s"]
    head = list(dict.fromkeys(head))
    return head + [f"tok{i}" if i % 2 else f"##p{i}"
                   for i in range(n - len(head))]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    coca = replica_state(12, 0.05, **COCA)
    torch.save(coca, d / "coca.pt")
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    bpe = _write_bpe(d / "bpe.txt.gz",
                     [(a, b) for a in letters for b in letters][:N_MERGES])
    g = torch.Generator().manual_seed(4)
    sd = minilm_state(g, 64, 2, 256, 80, 120)
    torch.save({"0.auto_model." + k: v for k, v in sd.items()},
               d / "sbert.pt")
    (d / "vocab.txt").write_text("\n".join(vocab_lines(120)) + "\n",
                                 encoding="utf-8")
    return dict(dir=d, coca=str(d / "coca.pt"), bpe=bpe,
                sbert=str(d / "sbert.pt"), vocab=str(d / "vocab.txt"))


def test_port_checkpoint_coca_as_jax_script(ckpts):
    argv = ["coca", "--checkpoint", ckpts["coca"], "--tokenizer",
            ckpts["bpe"], "--max-caption-len", "8"]
    want, _ = _run(_jax_script("port_checkpoint").main,
                   argv + ["--out", str(ckpts["dir"] / "jax_coca")], True)
    got, rc = _run(PORT.main, argv + ["--out", str(ckpts["dir"] / "coca")],
                   False)
    assert rc == 0
    assert set(got) == set(want)
    assert got["config"] == want["config"] == {
        "vision_width": 128, "vision_layers": 2, "image_size": 32,
        "vocab": 600, "text_layers": 2, "mm_blocks": 4, "bos": 598,
        "eos": 599}
    assert got["smoke_caption"] == want["smoke_caption"]
    assert got["smoke_tokens"] == want["smoke_tokens"]
    p = got["parity"]
    assert p["teacher_forced_corr"] > 0.999 and p["argmax_agreement"] > 0.9
    assert p["replica_missing"] == [] == p["checkpoint_unconsumed"]
    assert sorted(q.name for q in (ckpts["dir"] / "coca").iterdir()) == [
        "bpe.txt.gz", "config.json", "params.pkl"]


def test_port_checkpoint_sbert_as_jax_script(ckpts):
    argv = ["sbert", "--checkpoint", ckpts["sbert"], "--tokenizer",
            ckpts["vocab"], "--sentence", "a red couch in the living rooms"]
    want, _ = _run(_jax_script("port_checkpoint").main,
                   argv + ["--out", str(ckpts["dir"] / "jax_sbert")], True)
    got, rc = _run(PORT.main, argv + ["--out", str(ckpts["dir"] / "sbert")],
                   False)
    assert rc == 0 and set(got) == set(want)
    assert got["config"] == want["config"] == {
        "width": 64, "layers": 2, "vocab": 120, "post_ln": True}
    assert abs(got["smoke_embedding_norm"] - 1.0) < 1e-3
    np.testing.assert_allclose(got["smoke_embedding_head"],
                               want["smoke_embedding_head"], atol=1e-4)


def test_port_checkpoint_sbert_hf_parity(tmp_path):
    transformers = pytest.importorskip("transformers")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(vocab_lines(96)) + "\n", encoding="utf-8")
    cfg = transformers.BertConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64)
    torch.manual_seed(13)
    hf = transformers.BertModel(cfg).eval()
    hf_dir = tmp_path / "hf"
    hf.save_pretrained(hf_dir)
    transformers.BertTokenizer(str(vocab)).save_pretrained(hf_dir)
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    got, rc = _run(PORT.main, [
        "sbert", "--checkpoint", str(tmp_path / "pytorch_model.bin"),
        "--tokenizer", str(vocab), "--out", str(tmp_path / "out"),
        "--sentence", "a red couch in the living room", "--hf-dir",
        str(hf_dir)], False)
    assert rc == 0 and got["parity_cosine_vs_torch"] > 0.999


@pytest.mark.parametrize("kind", ["coca", "sbert"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ported_directory_loads_in_the_other_package(ckpts, tmp_path, kind,
                                                     writer):
    src = ckpts["bpe"] if kind == "coca" else ckpts["vocab"]
    if kind == "coca":
        params, cfg, _ = JP.port_coca(ckpts["coca"], src, max_caption_len=8)
    else:
        params, cfg, _ = JP.port_sbert(ckpts["sbert"], src)
    save, load = ((JP.save_ported, TP.load_ported) if writer == "jax"
                  else (TP.save_ported, JP.load_ported))
    save(str(tmp_path), params, cfg, src, kind)
    got_params, got_cfg, got_tok = load(str(tmp_path))
    n = same_tree(got_params, params)
    assert n > 20
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    assert type(got_cfg).__name__ == type(cfg).__name__
    assert got_tok.vocab_size == (cfg.text.vocab_size if kind == "coca"
                                  else cfg.vocab_size)
    # the other package's reader of its own directory gives the same
    (tmp_path / "again").mkdir()
    own_save = TP.save_ported if writer == "jax" else JP.save_ported
    own_save(str(tmp_path / "again"), got_params, got_cfg, src, kind)
    assert (tmp_path / "again" / "config.json").read_text() == (
        tmp_path / "config.json").read_text()


@pytest.fixture(scope="module")
def annotations(ckpts):
    """8 annotated boxes over an npz image, an npy image and a frame of an
    npz store (the "exp:episode:camera:step" form), 64^2 and 48x80."""
    rng = np.random.default_rng(ANNOTATION_SEED)
    d = ckpts["dir"]
    a = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    b = (rng.random((48, 80, 3)) * 255).astype(np.uint8)
    np.savez(d / "a.npz", a)
    np.save(d / "b.npy", b)
    save_obs(str(d / "store"), 2, {"rgb": b[::-1].copy()}, 5)
    refs = [(str(d / "a.npz"), 64, 64), (str(d / "b.npy"), 48, 80),
            (f"{d / 'store'}:2:0:5", 48, 80)]
    anns = []
    for i in range(8):
        ref, h, w = refs[i % 3]
        x1, y1 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
        anns.append({"image": ref, "caption": f"caption {i}", "box": [
            float(x1), float(y1), float(x1 + rng.uniform(4, w * 0.4)),
            float(y1 + rng.uniform(4, h * 0.4))]})
    path = d / "anns.json"
    path.write_text(json.dumps(anns))
    return str(path)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _same_csv(got, want):
    assert len(got) == len(want) > 0
    assert [r["reference"] for r in got] == [r["reference"] for r in want]
    assert [r["proposed"] for r in got] == [r["proposed"] for r in want]
    np.testing.assert_allclose([float(r["perplexity"]) for r in got],
                               [float(r["perplexity"]) for r in want],
                               rtol=5e-2)


def test_evaluate_ported_dir_as_jax_script(ckpts, annotations, tmp_path):
    ported = tmp_path / "ported"
    params, cfg, _ = TP.port_coca(ckpts["coca"], ckpts["bpe"],
                                  max_caption_len=8)
    TP.save_ported(str(ported), params, cfg, ckpts["bpe"], "coca")
    argv = [annotations, "--ported-dir", str(ported), "--batch", "3"]
    want, _ = _run(_jax_script("evaluate_finetuned_model").main,
                   argv + ["--out", str(tmp_path / "jax.csv")], True)
    got, rc = _run(EVAL.main, argv + ["--out", str(tmp_path / "port.csv")],
                   False)
    assert rc == 0
    assert got == dict(want, out=str(tmp_path / "port.csv"))
    rows = _rows(tmp_path / "port.csv")
    _same_csv(rows, _rows(tmp_path / "jax.csv"))
    assert sum(len(r["proposed"]) > 0 for r in rows) >= 6


def test_evaluate_checkpoint_as_jax_script(annotations, tmp_path):
    """A captioner pickle in the layout `finetune_captioner` writes (a
    numpy tree), the tiny preset and the framework tokenizer. The tiny
    preset's random logits are flatter than the converted CoCa's: over
    annotation seeds 3-6 and weight keys 0, 1, 2 and 6, 22 of 128 rows
    parted from the JAX script's; annotation seed 3 with key 1 parts
    none."""
    jcfg = JCfg.tiny()
    params = JCAP.init_captioner(jax.random.PRNGKey(1), jcfg)
    with open(tmp_path / "cap.pkl", "wb") as fh:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), fh)
    argv = [annotations, "--checkpoint", str(tmp_path / "cap.pkl"),
            "--preset", "tiny", "--batch", "4"]
    want, _ = _run(_jax_script("evaluate_finetuned_model").main,
                   argv + ["--out", str(tmp_path / "jax.csv")], True)
    got, rc = _run(EVAL.main, argv + ["--out", str(tmp_path / "port.csv")],
                   False)
    assert rc == 0 and got["rows"] == want["rows"] == 8
    _same_csv(_rows(tmp_path / "port.csv"), _rows(tmp_path / "jax.csv"))


def test_crops_equal_the_jax_scripts(annotations, ckpts):
    """The crop batch (expand by 0.2, crop_and_resize, truncate to uint8)
    against the JAX script's: the float crops differ in their last bits
    (sums in another order), so a value just under a whole level on one
    side may truncate one level lower than on the other; on these boxes 1
    of the 24,576 values does, held to 1e-3 of them and one level."""
    import jax.numpy as jnp

    from embodied_captioning_tpu.ops.detections import expand_boxes
    from embodied_captioning_tpu.ops.image import crop_and_resize

    anns = json.loads(Path(annotations).read_text())
    script = _jax_script("evaluate_finetuned_model")
    want = []
    for a in anns:
        img = script._load_image(a["image"])
        box = expand_boxes(jnp.asarray([a["box"]], jnp.float32), 0.2,
                           *img.shape[:2])
        want.append(crop_and_resize(jnp.asarray(img, jnp.float32), box,
                                    32)[0])
    want = np.asarray(jnp.stack(want).astype(jnp.uint8))
    got = EVAL.crop_batch(anns, 32, torch.device("cpu")).numpy()
    assert got.dtype == np.uint8 and got.shape == (8, 32, 32, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_port_refuses_what_jax_refuses(ckpts, tmp_path):
    """A merges table too short for the checkpoint's vocabulary, a
    tokenizer whose vocabulary differs from the checkpoint's, and a
    vocab.txt of another size, each with the JAX package's message."""
    short = _write_bpe(tmp_path / "short.txt.gz", [("a", "b")] * 10)
    state = torch.load(ckpts["coca"])
    other = TP.CLIPBPETokenizer([("a", "b")] * 5)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(vocab_lines(100)) + "\n", encoding="utf-8")
    cases = [
        lambda m: m.port_coca(ckpts["coca"], short),
        lambda m: m.infer_coca_config(state, other),
        lambda m: m.port_sbert(ckpts["sbert"], str(vocab)),
        lambda m: m._strip_bert_prefix({"x.weight": torch.zeros(1)}),
    ]
    for case in cases:
        msgs = []
        for mod in (JP, TP):
            with pytest.raises(ValueError) as exc:
                case(mod)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("main,argv", [
    (PORT.main, ["sbert", "--checkpoint", "x.pt", "--tokenizer", "v.txt",
                 "--out", "out"]),
    (EVAL.main, ["anns.json"])], ids=["port_checkpoint", "evaluate"])
def test_entry_points_run_on_the_card_by_default(main, argv):
    """Without --device both entry points ask for the card, and without
    one they stop: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("std", [0.02, 0.2])
def test_sentence_embedding_equals_jax_encode(tmp_path, std):
    """A ported MiniLM-class encoder computes in float32
    (`infer_sbert_config`): the port's embedding against the JAX
    package's `encode_tokens` on the same converted tree and ids, within
    1e-6. The JAX package takes the attention scores and probabilities in
    the compute dtype; the port's plain attention had rounded them to
    bf16 whatever the compute dtype (1.7e-5 apart at std 0.02, 7.2e-4 at
    0.2), and on the card its float32 query met a bf16 key in one cuBLAS
    call, which refuses mixed types; the repaired port reads 6.0e-8 and
    9.3e-8."""
    import jax.numpy as jnp

    from embodied_captioning_tpu_torch.models import sbert as TSB
    from embodied_captioning_tpu_torch.params import from_jax

    sd = minilm_state(torch.Generator().manual_seed(4), 64, 2, 256, 80, 120,
                      std)
    torch.save({"0.auto_model." + k: v for k, v in sd.items()},
               tmp_path / "sbert.pt")
    (tmp_path / "vocab.txt").write_text("\n".join(vocab_lines(120)) + "\n",
                                        encoding="utf-8")
    params, cfg, tok = TP.port_sbert(str(tmp_path / "sbert.pt"),
                                     str(tmp_path / "vocab.txt"))
    assert cfg.dtype == "float32"
    ids = tok.encode_batch(["a red couch", "the living rooms in a room",
                            "zzz unknown"], cfg.max_len)
    want = np.asarray(JSB.encode_tokens(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids), cfg))
    got = TSB.encode_tokens(from_jax(params, "cpu"), torch.from_numpy(ids),
                            cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
