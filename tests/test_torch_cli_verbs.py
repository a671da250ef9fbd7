"""The port's command-line verbs against the JAX command line's (``bsyolo_tpu/cli.py``), on the CPU.

``version``, ``cfg`` (the text ``yaml.safe_dump`` gives, which the port writes
without PyYAML), ``checks``, ``settings`` (view, ``k=v`` update, ``reset``, an
unknown key) on one shared settings file under a temporary ``HOME``, ``copy-cfg``,
and ``predict`` saving its drawings by default in the JAX layout. ``solutions``
is still to come and raises naming its ROADMAP item.
"""

import json
from pathlib import Path

import pytest
import yaml

FIXTURES = Path(__file__).parent / "fixtures"
TINY = str(FIXTURES / "tiny.yaml")
IMAGES = FIXTURES / "bsyolo8" / "images" / "train"


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture
def home(tmp_path, monkeypatch):
    """A temporary HOME: both packages' settings live under it, never under the user's."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path / "home"


def test_version_matches_jax(capsys):
    from bsyolo_tpu.cli import main as jax_main

    from bsyolo_tpu_torch import __version__
    from bsyolo_tpu_torch.cli import main

    assert _run(main, ["version"], capsys) == _run(jax_main, ["version"], capsys) == f"{__version__}\n"


def test_cfg_matches_jax(capsys):
    from bsyolo_tpu.cfg import DEFAULT_CFG_DICT as JAX_CFG
    from bsyolo_tpu.cli import main as jax_main

    from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, dump_yaml
    from bsyolo_tpu_torch.cli import main

    got = _run(main, ["cfg"], capsys)
    assert got == _run(jax_main, ["cfg"], capsys)
    assert dump_yaml(DEFAULT_CFG_DICT) == yaml.safe_dump(JAX_CFG, sort_keys=False)
    assert yaml.safe_load(got) == DEFAULT_CFG_DICT


@pytest.mark.parametrize("value", [1e-05, 1e17, 2.5, float("inf"), "yes", "1.0", "", "a: b", "null", "it's", "-x", "- x",
                                   "botsort.yaml", None, True, 0], ids=repr)
def test_yaml_writer_matches_pyyaml_on_scalars(value):
    from bsyolo_tpu_torch.cfg import dump_yaml

    d = {"key": value}
    assert dump_yaml(d) == yaml.safe_dump(d, sort_keys=False)


def test_checks_names_the_port_and_torch(capsys):
    import torch

    from bsyolo_tpu_torch import __version__
    from bsyolo_tpu_torch.cli import main

    out = _run(main, ["checks"], capsys).splitlines()
    assert out[0] == f"bsyolo_tpu_torch {__version__}"
    assert out[1].startswith(f"torch {torch.__version__} (CUDA {torch.version.cuda}), devices: ")


def _without_uuid(text: str) -> dict:
    d = json.loads(text)
    assert len(d.pop("uuid")) == 32
    return d


def test_settings_view_update_reset_match_jax(home, capsys):
    from bsyolo_tpu.cli import main as jax_main
    from bsyolo_tpu.utils.settings import SettingsManager as JaxSettings

    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.utils.settings import SettingsManager, datasets_dir, settings_file

    file = home / ".config" / "bsyolo_tpu" / "settings.json"
    assert settings_file() == file
    first = _run(main, ["settings"], capsys)  # the port creates the file; the JAX command line reads it as it is
    assert file.exists() and _run(jax_main, ["settings"], capsys) == first
    assert list(json.loads(first)) == list(JaxSettings(str(home / "other.json")))  # the same keys in the same order
    assert _without_uuid(first) == _without_uuid(json.dumps(dict(JaxSettings(str(file))), indent=2))
    updated = _run(main, ["settings", "datasets_dir=/data/sets", "sync=True", "tensorboard=false"], capsys)
    assert updated == _run(jax_main, ["settings"], capsys) == file.read_text() + "\n"
    d = json.loads(updated)
    assert (d["datasets_dir"], d["sync"], d["tensorboard"]) == ("/data/sets", True, False)
    assert datasets_dir() == Path("/data/sets") and SettingsManager()["sync"] is True
    _run(jax_main, ["settings", "runs_dir=/r"], capsys)
    assert SettingsManager()["runs_dir"] == "/r"  # the JAX package's update, read by the port
    reset = _run(main, ["settings", "reset"], capsys)
    jax_reset = _run(jax_main, ["settings", "reset"], capsys)
    assert _without_uuid(reset) == _without_uuid(jax_reset) and json.loads(reset)["datasets_dir"] != "/data/sets"


def test_settings_unknown_key_raises_as_jax(home, capsys):
    from bsyolo_tpu.cli import main as jax_main

    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.utils.settings import SettingsManager

    errors = []
    for m in (main, jax_main):
        with pytest.raises(SyntaxError) as e:
            m(["settings", "datasets_dir=/d", "bogus=1"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "bogus" in errors[0]
    s = SettingsManager()
    assert s["datasets_dir"] != "/d"  # nothing written
    with pytest.raises(SyntaxError, match="bogus"):
        s["bogus"] = 1


def test_settings_file_of_another_version_or_not_json(tmp_path):
    from bsyolo_tpu.utils.settings import SettingsManager as JaxSettings

    from bsyolo_tpu_torch.utils.settings import SettingsManager

    for text in ('{"settings_version": "0.0.1", "runs_dir": "/old", "gone": 1}', "not json", "[1, 2]"):
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        a.write_text(text)
        b.write_text(text)
        got, want = SettingsManager(str(a)), JaxSettings(str(b))
        got.pop("uuid"), want.pop("uuid")
        assert dict(got) == dict(want)
        assert _without_uuid(a.read_text()) == _without_uuid(b.read_text())


def test_copy_cfg_matches_jax(tmp_path, monkeypatch):
    from bsyolo_tpu.cli import main as jax_main

    from bsyolo_tpu_torch.cfg import DEFAULT_CFG_PATH
    from bsyolo_tpu_torch.cli import main

    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_main(["copy-cfg"]) == 0
    monkeypatch.chdir(tmp_path)
    assert main(["copy-cfg"]) == 0
    got = (tmp_path / "default_copy.yaml").read_bytes()
    assert got == DEFAULT_CFG_PATH.read_bytes()
    assert yaml.safe_load(got) == yaml.safe_load((tmp_path / "jax" / "default_copy.yaml").read_bytes())


def test_cli_predict_saves_by_default_in_the_jax_layout(tmp_path):
    from bsyolo_tpu.cli import main as jax_main

    from bsyolo_tpu_torch.cli import main

    args = [f"model={TINY}", f"source={IMAGES}", "imgsz=64", "conf=0.001", f"project={tmp_path}"]
    assert jax_main(["predict", *args, "name=jax"]) == 0
    assert main(["predict", *args, "name=port", "device=cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == [f"{i}.jpg" for i in range(8)]
    assert main(["predict", *args, "name=off", "device=cpu", "save=False"]) == 0
    assert not (tmp_path / "off").exists()


def test_solutions_raises_naming_its_item():
    from bsyolo_tpu_torch.cli import main

    with pytest.raises(NotImplementedError, match="item 16"):
        main(["solutions", "count", "source=x.mp4"])
