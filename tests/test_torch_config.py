"""The port's configuration tree (config.py) against the JAX package's
`load_config` / `to_dict`: presets, YAML overlays and dotlist overrides
give equal dicts (exact equality)."""

from pathlib import Path

import pytest

from embodied_captioning_tpu import config as J
from embodied_captioning_tpu_torch import config as T

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob(
    "*.yaml"))
DOTLIST = ["runtime.num_envs=3", "sim.episode_steps=2",
           "sensors.height=128", "map.grid=[32,8,32]",
           "detector.score_threshold=0.0", "runtime.obs_dir=/x/y",
           "ppo.lr=1e-4", "policy.hidden=64", "captioner.text.layers=1"]


@pytest.mark.parametrize("preset", ["tiny", "base", "large"])
def test_presets_equal(preset):
    assert T.to_dict(T.load_config(preset)) == J.to_dict(J.load_config(preset))


@pytest.mark.parametrize("yaml_path", YAMLS)
@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_yaml_overlays_equal(preset, yaml_path):
    path = str(REPO / yaml_path)
    assert T.to_dict(T.load_config(preset, yaml_path=path)) == J.to_dict(
        J.load_config(preset, yaml_path=path))


def test_dotlist_equal_and_typed():
    out = T.load_config("tiny", overrides=DOTLIST)
    assert T.to_dict(out) == J.to_dict(J.load_config("tiny",
                                                     overrides=DOTLIST))
    assert out.map.grid == (32, 8, 32) and out.runtime.obs_dir == "/x/y"


def test_field_names_and_classes_equal():
    jcfg, tcfg = J.ExperimentConfig(), T.ExperimentConfig()
    assert list(T.to_dict(tcfg)) == list(J.to_dict(jcfg))
    for name in ("COCO_CLASS_IDS", "CLASS_NAMES", "COCO_TO_LOCAL",
                 "LOCAL_TO_COCO", "NUM_CLASSES", "CLIP_VOCAB_SIZE"):
        assert getattr(T, name) == getattr(J, name), name
    with pytest.raises(KeyError, match="unknown config key"):
        T.apply_dotlist(tcfg, ["runtime.no_such_key=1"])
