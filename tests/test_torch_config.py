"""The port's layered config (project_morpheus_tpu_torch.config) mirrors
``tests/test_config.py``: bootstrap, precedence, coerced persistence; and
it writes the same files as the JAX package's for the same updates.  HOME
and the working directory point at ``tmp_path``; every key a test writes
to ``os.environ`` is restored after it."""
import os

import pytest

from project_morpheus_tpu import config as jax_cfg
from project_morpheus_tpu_torch import config as cfg

WRITTEN = ("ORPHEUS_MAX_TOKENS", "ORPHEUS_TOP_P", "FLAG", "K")


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cfg, "HOME_CONFIG", tmp_path / ".morpheus_tpu" / "config")
    monkeypatch.setattr(jax_cfg, "HOME_CONFIG", tmp_path / ".morpheus_tpu" / "jax_config")
    for key in WRITTEN:
        monkeypatch.delenv(key, raising=False)


def test_defaults_match_jax_but_the_engine_mode():
    ours, theirs = dict(cfg.DEFAULTS), dict(jax_cfg.DEFAULTS)
    assert ours.pop("ORPHEUS_ENGINE_MODE") == "torch"
    assert theirs.pop("ORPHEUS_ENGINE_MODE") == "jax"
    assert ours == theirs


def test_bootstrap_from_example(tmp_path):
    (tmp_path / ".env.example").write_text("FOO=bar\n")
    env = cfg.ensure_env_file_exists(tmp_path)
    assert env.read_text() == "FOO=bar\n"


def test_bootstrap_defaults_without_example(tmp_path):
    env = cfg.ensure_env_file_exists(tmp_path)
    assert "ORPHEUS_TEMPERATURE=0.6" in env.read_text()
    assert "ORPHEUS_ENGINE_MODE=torch" in env.read_text()


def test_precedence_env_beats_files(tmp_path, monkeypatch):
    (tmp_path / ".env.example").write_text("K=example\n")
    assert cfg.get_current_config(tmp_path)["K"] == "example"
    (tmp_path / ".env").write_text("K=envfile\n")
    assert cfg.get_current_config(tmp_path)["K"] == "envfile"
    cfg.HOME_CONFIG.parent.mkdir(parents=True)
    cfg.HOME_CONFIG.write_text("K=home\n")
    assert cfg.get_current_config(tmp_path)["K"] == "home"
    monkeypatch.setenv("K", "osenv")
    assert cfg.get_current_config(tmp_path)["K"] == "osenv"


def test_save_coerces_and_mirrors_like_jax(tmp_path):
    updates = {"ORPHEUS_MAX_TOKENS": 100.0, "ORPHEUS_TOP_P": 0.85, "FLAG": True}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_cfg.save_config(updates, base_dir=tmp_path / "jax")
    cfg.save_config(updates, base_dir=tmp_path / "port")
    env_text = (tmp_path / "port" / ".env").read_text()
    assert env_text == (tmp_path / "jax" / ".env").read_text().replace(
        "ORPHEUS_ENGINE_MODE=jax", "ORPHEUS_ENGINE_MODE=torch")
    assert "ORPHEUS_MAX_TOKENS=100" in env_text  # float -> int coercion
    assert "ORPHEUS_TOP_P=0.85" in env_text and "FLAG=true" in env_text
    assert cfg.HOME_CONFIG.read_text() == jax_cfg.HOME_CONFIG.read_text()
    assert "ORPHEUS_MAX_TOKENS=100" in cfg.HOME_CONFIG.read_text()
    assert os.environ["ORPHEUS_MAX_TOKENS"] == "100"
