"""The port imports neither JAX nor the JAX package (AST scan), and names
no file of the JAX package's native library."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "embodied_captioning_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "embodied_captioning_tpu")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES + sorted(
    (REPO / "embodied_captioning_tpu_torch").rglob("*.cpp")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_to_the_jax_native_library(path):
    """The port builds its own copy of ccl3d.cpp (mapping/components.py):
    no file names the JAX package's native directory or its library, so
    nothing can load it by path, which the import scan cannot see."""
    text = path.read_text()
    for needle in ("libecap_native", "embodied_captioning_tpu/native",
                   '"embodied_captioning_tpu", "native"',
                   "'embodied_captioning_tpu', 'native'"):
        assert needle not in text, (path, needle)


def test_scan_covers_every_subpackage_and_the_smoke_script():
    scanned = {str(p.relative_to(REPO)) for p in FILES}
    pkg = "embodied_captioning_tpu_torch/"
    for rel in ("envs/sim.py", "envs/device_loop.py", "mapping/voxel_map.py",
                "mapping/consensus.py", "ops/geometry.py", "ops/cosine.py",
                "kernels/raycast.py", "kernels/layernorm.py",
                "kernels/preprocess.py", "kernels/decode_attention.py",
                "models/captioner.py", "sensor_data.py", "perception.py",
                "envs/env.py", "envs/vector_env.py", "agents/baselines.py",
                "utils/obs_store.py", "mapping/components.py", "run_exp.py",
                "agents/policy.py", "agents/storage.py", "agents/ppo.py",
                "agents/goal_exploration.py", "agents/extra_trainers.py",
                "utils/profiling.py", "utils/logging.py", "train/optim.py",
                "train/captioner_train.py", "labeling/datasets.py",
                "finetune_captioner.py", "utils/metrics.py",
                "ops/augment.py", "selfcheck_training.py",
                "selfcheck_detector.py", "labeling/pseudolabeler.py",
                "labeling/pseudocaptioner.py", "labeling/caption_datasets.py",
                "train/pipelines.py", "run_pseudolabeler.py",
                "pseudocaption.py", "train_detector.py",
                "models/query_detector.py", "ops/assignment.py",
                "export_serving_artifact.py", "eval_artifact.py",
                "models/llm.py", "models/blip2.py", "models/florence.py",
                "parallel/mesh.py", "parallel/moe.py",
                "parallel/pipeline.py", "parallel/sequence.py",
                "agents/ddppo.py", "utils/checkpoint.py",
                "utils/coco.py", "utils/extras.py",
                "models/tokenizer_artifacts.py", "tools/convert_weights.py",
                "tools/torch_replica.py", "tools/port.py",
                "port_checkpoint.py", "evaluate_finetuned_model.py",
                "selfcheck_loop.py", "selfcheck_rl.py",
                "selfcheck_cycle.py", "selfcheck_teacher_student.py",
                "compute_cosine_sim.py", "compute_detection_statistics.py",
                "compute_performance_measures.py", "caption_tools.py",
                "visualize_exp.py", "visualize_cosine_similarity.py",
                "build_vocab.py"):
        assert pkg + rel in scanned, rel
    assert "chip_smoke.py" in scanned
    # every directory of the package that holds Python files is scanned
    dirs = {p.parent for p in (REPO / pkg).rglob("*.py")}
    assert all(any(f.parent == d for f in FILES) for d in dirs)


def test_every_kernel_has_a_signature_a_counter_and_a_source():
    from embodied_captioning_tpu_torch.kernels import _lib

    names = {"flash_attention", "decode_self_attention",
             "decode_cross_attention", "decode_mlp", "decode_self_block",
             "decode_cross_block", "raycast_minargmin", "layernorm",
             "layernorm_bwd", "fused_preprocess"}
    assert set(_lib.launches) == names
    # and one entry that launches nothing: the LayerNorm backward's query
    # of the clusters a card holds at once, for its launch plan
    assert set(_lib._SIGNATURES) == {"ecap_" + n for n in names} | {
        "ecap_layernorm_bwd_slots"}
    sources = "".join(p.read_text() for p in _lib.CSRC.glob("*.cu"))
    for name in _lib._SIGNATURES:
        assert f'extern "C" int {name}(' in sources, name
