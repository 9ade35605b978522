"""The port's ``brainplex/`` and ``read_openclaw_config`` against the JAX
package's.

``run_init`` of each package over one fake home (the same directory, reset
between the runs) writes byte-equal plugin configs, ``openclaw.json`` and
backups (the backup's name equal less its time stamp) and prints the same
lines, for every agent-config shape, with and without ``--full``, dry run,
an existing plugin entry and an existing plugin config. The scanner's
discovery, JSON5-tolerant parse and four agent shapes; the writer's
never-overwrite rule, merge and backups; the installer's bundled,
``openclaw`` and ``pip`` sources through injected ``run_cmd``, ``which``
and ``find_module`` (no subprocess, no network); the CLI's exit codes 0, 1
and 2. The port's ``manifest_for`` resolves the port's plugin modules, and
their manifests hold the generated configs as JAX's do.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import shutil
import sys
from importlib import import_module
from pathlib import Path

import pytest

from helpers import FakeClock
from vainplex_openclaw_tpu.brainplex import cli as jax_cli
from vainplex_openclaw_tpu.brainplex import configurator as jax_conf
from vainplex_openclaw_tpu.brainplex import installer as jax_inst
from vainplex_openclaw_tpu.brainplex import scanner as jax_scan
from vainplex_openclaw_tpu.brainplex import writer as jax_writer
from vainplex_openclaw_tpu.config import loader as jax_loader
from vainplex_openclaw_tpu_torch.brainplex import cli as port_cli
from vainplex_openclaw_tpu_torch.brainplex import configurator as port_conf
from vainplex_openclaw_tpu_torch.brainplex import installer as port_inst
from vainplex_openclaw_tpu_torch.brainplex import scanner as port_scan
from vainplex_openclaw_tpu_torch.brainplex import writer as port_writer
from vainplex_openclaw_tpu_torch.config import loader as port_loader

PACKAGES = {"jax": (jax_cli, jax_conf, jax_inst, jax_scan, jax_writer),
            "port": (port_cli, port_conf, port_inst, port_scan, port_writer)}
STAMP_RE = re.compile(r"\.backup-\d{8}-\d{6}$")
TMP_RE = re.compile(r"brainplex-install-[^/]+")
PORT_MODULES = {"governance": "governance", "cortex": "cortex",
                "eventstore": "events", "knowledge-engine": "knowledge",
                "sitrep": "sitrep"}


def tree(root: Path) -> dict:
    """``{relative path: bytes}`` under ``root``, a backup's stamp
    replaced by ``<stamp>``."""
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file():
            rel = STAMP_RE.sub(".backup-<stamp>", str(path.relative_to(root)))
            out[rel] = path.read_bytes()
    return out


def args(**over) -> dict:
    return {"command": "init", "full": False, "dry_run": False,
            "config": None, "no_color": True, "verbose": True, "yes": True,
            **over}


CONFIGS = {
    "flat": {"agents": [{"id": "main"}, {"name": "forge-bot"}, "scout"]},
    "list": {"agents": {"list": ["main", "admin-ops", "viola"]},
             "theme": "dark"},
    "definitions": {"agents": {"definitions": [{"id": "cerberus-2"},
                                               {"id": "forge-7"}]}},
    "named": {"agents": {"root": {}, "cerberus": {}, "defaults": {}}},
    "existing": {"agents": ["main"], "plugins": {
        "governance": {"enabled": False, "configPath": "/custom.json"}}},
    "none": {"version": "2.1.0"},
}
JSON5 = ('{\n  // my agents\n  "agents": {"list": ["main", "helper",],},\n'
         '  /* a comment */ "theme": "dark",\n}\n')


def run_both(tmp_path, setup, call) -> list:
    """``setup(home)`` then ``call(package, home)`` for each package in the
    same fresh directory; each run's return value, printed lines and
    files."""
    home = tmp_path / "home"
    out = []
    for name in ("jax", "port"):
        if home.exists():
            shutil.rmtree(home)
        home.mkdir()
        setup(home)
        stream = io.StringIO()
        result = call(PACKAGES[name], home, stream)
        out.append({"result": result, "printed": stream.getvalue(),
                    "files": tree(home)})
    return out


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case", sorted(CONFIGS) + ["json5"])
def test_run_init_writes_what_jax_writes(tmp_path, case, full):
    def setup(home):
        oc = home / ".openclaw"
        oc.mkdir()
        text = JSON5 if case == "json5" else json.dumps(CONFIGS[case],
                                                         indent=2)
        (oc / "openclaw.json").write_text(text, encoding="utf-8")
        (home / "work" / "deep").mkdir(parents=True)

    def call(pkg, home, stream):
        cli = pkg[0]
        out = cli.Output(color=False, verbose=True, stream=stream)
        first = cli.run_init(args(full=full), start_dir=str(home / "work"
                                                            / "deep"),
                             home=home, out=out)
        again = cli.run_init(args(full=full), start_dir=str(home / "work"),
                             home=home, out=out)
        return [first, again]

    jax_run, port_run = run_both(tmp_path, setup, call)
    assert port_run == jax_run
    assert port_run["result"] == [0, 0]
    assert "nothing to do" in port_run["printed"]
    files = port_run["files"]
    assert ".openclaw/openclaw.json.backup-<stamp>" in files
    n_plugins = sum(k.endswith("/config.json") for k in files)
    assert n_plugins == (5 if full else 4) - (case == "existing")


@pytest.mark.parametrize("mode", ["dry_run", "explicit", "no_config",
                                  "kept_config", "abort", "unparseable"])
def test_run_init_paths_equal_jax(tmp_path, mode):
    def setup(home):
        (home / "proj").mkdir()
        if mode == "unparseable":
            (home / "proj" / "openclaw.json").write_text("{not json")
        elif mode != "no_config":
            (home / "proj" / "openclaw.json").write_text(json.dumps(
                {"agents": {"list": ["main", "forge"]}}))
        if mode == "kept_config":
            cfg = home / "proj" / "plugins" / "governance" / "config.json"
            cfg.parent.mkdir(parents=True)
            cfg.write_text('{"enabled": false, "custom": true}')

    def call(pkg, home, stream):
        cli = pkg[0]
        out = cli.Output(color=False, verbose=True, stream=stream)
        over = {"dry_run": mode == "dry_run", "yes": mode != "abort",
                "config": (str(home / "proj" / "openclaw.json")
                           if mode == "explicit" else None)}
        return cli.run_init(args(**over), start_dir=str(home / "proj"),
                            home=home / "nohome", out=out,
                            confirm=lambda prompt: False)

    jax_run, port_run = run_both(tmp_path, setup, call)
    assert port_run == jax_run
    assert port_run["result"] == (1 if mode in ("no_config", "abort",
                                                "unparseable") else 0)


def test_all_installs_failing_exits_2_as_in_jax(tmp_path, monkeypatch):
    for _, _, inst, _, _ in PACKAGES.values():
        monkeypatch.setattr(inst, "PLUGIN_SPECS", {
            k: ("nonexistent.module_xyz", d)
            for k, (m, d) in inst.PLUGIN_SPECS.items()})

    def setup(home):
        (home / "openclaw.json").write_text('{"agents": ["main"]}')

    def call(pkg, home, stream):
        cli = pkg[0]
        calls = []

        def fail(cmd, cwd=None):
            calls.append(cmd[:3] if cmd[0] == "openclaw" else cmd[1:4])
            raise RuntimeError("registry unreachable")

        out = cli.Output(color=False, verbose=True, stream=stream)
        return [cli.run_init(args(), start_dir=str(home), home=home / "n",
                             out=out, run_cmd=fail), calls]

    jax_run, port_run = run_both(tmp_path, setup, call)
    assert port_run == jax_run
    assert port_run["result"][0] == 2
    assert "All plugin installations failed." in port_run["printed"]


@pytest.mark.parametrize("argv", [[], ["help"], ["init", "--bogus"],
                                  ["init", "--config"]])
def test_cli_main_equals_jax(argv, capsys):
    out = []
    for cli in (jax_cli, port_cli):
        try:
            out.append(("exit", cli.main(argv)))
        except SystemExit as exc:
            out.append(("system_exit", str(exc.code)))
        out.append(capsys.readouterr().out)
    assert out[2:] == out[:2]
    assert port_cli.USAGE == jax_cli.USAGE


def test_cli_main_init_through_openclaw_home(tmp_path, monkeypatch, capsys):
    """``main(["init", "--full", "--yes", "--config", ...])`` as a user
    runs it: the same exit code, lines and files as JAX's."""
    home = tmp_path / "oc"
    results = []
    for cli in (jax_cli, port_cli):
        if home.exists():
            shutil.rmtree(home)
        home.mkdir()
        (home / "openclaw.json").write_text(json.dumps(
            {"agents": {"list": ["main", "forge", "scout"]}}))
        monkeypatch.setenv("OPENCLAW_HOME", str(home))
        monkeypatch.chdir(tmp_path)
        code = cli.main(["init", "--full", "--yes", "--config",
                         str(home / "openclaw.json"), "--no-color"])
        results.append([code, capsys.readouterr().out, tree(home)])
    assert results[1] == results[0]
    assert results[0][0] == 0


# ── scanner ──────────────────────────────────────────────────────────

AGENT_SHAPES = [
    {"agents": [{"id": "a"}, {"name": "b"}, "c", 7, {"id": 3}]},
    {"agents": {"list": ["main", {"id": "x"}]}},
    {"agents": {"definitions": [{"id": "x"}, {"name": "y"}]}},
    {"agents": {"main": {}, "defaults": {}, "ops": {"model": "m"}}},
    {"agents": {"list": "not-a-list", "definitions": None, "z": 1}},
    {"agents": "main"}, {"agents": []}, {"agents": None}, {},
]


@pytest.mark.parametrize("i", range(len(AGENT_SHAPES)))
def test_extract_agents_equals_jax(i):
    cfg = AGENT_SHAPES[i]
    assert port_scan.extract_agents(cfg) == jax_scan.extract_agents(cfg)


@pytest.mark.parametrize("text", [
    JSON5, '{"a": 1}', '{"a": [1, 2,], // c\n "b": {"c": 2,},}',
    '/* only */ {"x": "http://not-a-comment"}', "[1, 2,]", "{broken",
    '"string"', "7"])
def test_parse_config_equals_jax(text):
    got = []
    for scan in (jax_scan, port_scan):
        try:
            got.append(("ok", scan.parse_config(text)))
        except json.JSONDecodeError as exc:
            got.append(("raised", exc.msg))
    assert got[1] == got[0]


def test_find_config_and_scan_equal_jax(tmp_path):
    (tmp_path / "proj" / "a" / "b").mkdir(parents=True)
    (tmp_path / "proj" / "openclaw.json").write_text('{"agents": ["p"]}')
    (tmp_path / "nest" / ".openclaw").mkdir(parents=True)
    (tmp_path / "nest" / ".openclaw" / "openclaw.json").write_text(
        '{"agents": {"list": ["n"]}, "plugins": {"sitrep": {}}}')
    home = tmp_path / "home"
    (home / ".openclaw").mkdir(parents=True)
    (home / ".openclaw" / "openclaw.json").write_text("[1]")
    (tmp_path / "lonely").mkdir()
    for start, h, explicit in (
            ("proj/a/b", "nohome", None), ("nest", "nohome", None),
            ("lonely", "home", None), ("lonely", "nohome", None),
            ("lonely", "nohome", "proj/openclaw.json"),
            ("lonely", "nohome", "proj/missing.json")):
        start_dir, home_dir = tmp_path / start, tmp_path / h
        cfg = str(tmp_path / explicit) if explicit else None
        assert port_scan.find_config(start_dir, home_dir) == \
            jax_scan.find_config(start_dir, home_dir)
        assert port_scan.scan(start_dir, home=home_dir, config_path=cfg) == \
            jax_scan.scan(start_dir, home=home_dir, config_path=cfg)
    assert port_scan.check_runtime() == jax_scan.check_runtime()


# ── writer ───────────────────────────────────────────────────────────


def test_writer_equals_jax(tmp_path):
    def setup(home):
        (home / "openclaw.json").write_text(JSON5, encoding="utf-8")
        (home / "kept.json").write_text('{"mine": true}')
        (home / "bad.json").write_text("{nope")

    def call(pkg, home, stream):
        w = pkg[4]
        clock = FakeClock(1_700_000_000.0)
        entries = {"governance": {"enabled": True, "configPath": "/g"},
                   "sitrep": {"enabled": True}}
        return [
            w.write_config(home / "kept.json", {"x": 1}),
            w.write_config(home / "new" / "config.json", {"x": 1}),
            w.write_config(home / "dry.json", {"x": 1}, dry_run=True),
            w.update_openclaw_config(home / "openclaw.json", entries,
                                     dry_run=True, clock=clock),
            w.update_openclaw_config(home / "openclaw.json", entries,
                                     clock=clock),
            w.update_openclaw_config(home / "openclaw.json",
                                     {"governance": {"enabled": False}},
                                     clock=clock),
            w.update_openclaw_config(home / "bad.json", entries, clock=clock),
            w.update_openclaw_config(home / "fresh.json", entries,
                                     clock=clock),
            str(w.backup_path(home / "x.json", clock).name)]

    jax_run, port_run = run_both(tmp_path, setup, call)
    assert port_run == jax_run
    res = port_run["result"]
    assert res[0]["action"] == "kept-existing" and res[1]["action"] == \
        "created" and res[6]["action"] == "error"
    assert res[8] == "x.json.backup-20231114-221320"
    assert port_run["files"]["kept.json"] == b'{"mine": true}'
    assert port_run["files"]["openclaw.json.backup-<stamp>"] == \
        JSON5.encode()


# ── installer ────────────────────────────────────────────────────────


def fake_pip(cmd, cwd=None):
    target = Path(cmd[cmd.index("--target") + 1])
    dist = cmd[-1]
    pkg = target / dist.replace("-", "_")
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(f"# {dist}\n")
    (target / f"{dist}.dist-info").mkdir()
    return f"Successfully installed {dist}-1.2.{len(dist) % 7}"


SOURCES = {
    "bundled": (lambda cmd, cwd=None: "", lambda n: None, None),
    "openclaw": (lambda cmd, cwd=None: f"added {cmd[-1]}-0.8.6",
                 lambda n: "/usr/bin/openclaw", lambda m: None),
    "pip": (fake_pip, lambda n: None, lambda m: None),
    "failing": (lambda cmd, cwd=None: (_ for _ in ()).throw(
        RuntimeError("network down " + "x" * 300)), lambda n: "/bin/openclaw",
                lambda m: None),
    "raising_spec": (fake_pip, lambda n: None,
                     lambda m: (_ for _ in ()).throw(ImportError(m))),
    "empty_pip": (lambda cmd, cwd=None: "ok", lambda n: None,
                  lambda m: None),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_install_sources_equal_jax(tmp_path, source):
    run_cmd, which, find_module = SOURCES[source]

    def setup(home):
        (home / "tmp").mkdir()

    def call(pkg, home, stream):
        inst = pkg[2]
        calls = []

        def recorded(cmd, cwd=None):
            calls.append([TMP_RE.sub("brainplex-install-<tmp>",
                                     c.replace(str(home), "<home>"))
                          for c in cmd])
            return run_cmd(cmd, cwd)

        kwargs = {} if find_module is None else {"find_module": find_module}
        res = inst.install_plugins(
            list(inst.PLUGIN_SPECS) + ["nonsense"], workspace=home,
            run_cmd=recorded, which=which, tmp_root=home / "tmp", **kwargs)
        rows = [dataclasses.asdict(e) for e in res.installed + res.failed]
        return [rows, res.all_failed, calls, inst.has_openclaw_cli(which)]

    jax_run, port_run = run_both(tmp_path, setup, call)
    calls = [c for c in port_run["result"][2]]
    for c in calls:
        if c[0] == sys.executable:
            assert c[1:5] == ["-m", "pip", "install", "--no-deps"]
    assert port_run == jax_run
    rows = port_run["result"][0]
    assert rows[-1]["error"] == "unknown plugin id: nonsense"
    if source == "bundled":
        assert [r["source"] for r in rows[:-1]] == ["bundled"] * 5
    if source == "pip":
        assert "extensions/governance/__init__.py" in port_run["files"]


def test_plugin_specs_name_the_port_and_jax_distributions():
    assert set(port_inst.PLUGIN_SPECS) == set(jax_inst.PLUGIN_SPECS)
    for pid, (module, dist) in port_inst.PLUGIN_SPECS.items():
        assert dist == jax_inst.PLUGIN_SPECS[pid][1]
        assert module == f"vainplex_openclaw_tpu_torch.{PORT_MODULES[pid]}"
        assert import_module(module).__name__ == module
    assert port_inst.INSTALL_TIMEOUT_S == jax_inst.INSTALL_TIMEOUT_S


@pytest.mark.parametrize("text", [
    "Successfully installed vainplex-openclaw-governance-0.8.6",
    "added x-1.2.3rc1\n", "no version", "a-1.2\nb-3.4.5.post1  ", ""])
def test_extract_version_equals_jax(text):
    assert port_inst.extract_version(text) == jax_inst.extract_version(text)


# ── configurator and manifests ───────────────────────────────────────


def test_manifest_for_resolves_the_port_modules():
    for pid, sub in PORT_MODULES.items():
        manifest = port_conf.manifest_for(pid)
        module = import_module(f"vainplex_openclaw_tpu_torch.{sub}.plugin")
        assert manifest is module.MANIFEST and manifest.id == pid
        jax_manifest = jax_conf.manifest_for(pid)
        assert manifest.config_schema == jax_manifest.config_schema
    assert port_conf.manifest_for("membrane") is None


@pytest.mark.parametrize("agents", [[], ["main"], ["admin", "main-2",
                                                   "Cerberus", "forge", "x"]])
def test_generated_configs_equal_jax_and_validate(agents):
    ids = list(port_conf.CORE_PLUGINS + port_conf.OPTIONAL_PLUGINS) + ["x"]
    configs = port_conf.generate_configs(ids, agents)
    assert configs == jax_conf.generate_configs(ids, agents)
    assert port_conf.validate_generated(configs) == {}
    bad = {"governance": {"failMode": "sideways"},
           "cortex": {"languages": 3}, "sitrep": {"intervalMinutes": "x"},
           "unknown-plugin": {"whatever": 1}}
    assert port_conf.validate_generated(bad) == \
        jax_conf.validate_generated(bad)
    assert "governance" in port_conf.validate_generated(bad)
    for name in agents + ["*"]:
        assert port_conf.compute_trust_score(name) == \
            jax_conf.compute_trust_score(name)
    assert (port_conf.CORE_PLUGINS, port_conf.OPTIONAL_PLUGINS) == \
        (jax_conf.CORE_PLUGINS, jax_conf.OPTIONAL_PLUGINS)


# ── read_openclaw_config ─────────────────────────────────────────────


@pytest.mark.parametrize("content", [None, '{"agents": ["main"]}', "[]",
                                     "null", "{broken", '{"plugins": {}}'])
def test_read_openclaw_config_equals_jax(tmp_path, monkeypatch, content):
    env_home, arg_home = tmp_path / "env", tmp_path / "arg"
    for home in (env_home, arg_home):
        home.mkdir()
        if content is not None:
            (home / "openclaw.json").write_text(content)
    (arg_home / "openclaw.json").write_text('{"from": "arg"}')
    monkeypatch.setenv("OPENCLAW_HOME", str(env_home))
    got = port_loader.read_openclaw_config()
    assert got == jax_loader.read_openclaw_config()
    assert port_loader.read_openclaw_config(arg_home) == \
        jax_loader.read_openclaw_config(str(arg_home)) == {"from": "arg"}
    monkeypatch.delenv("OPENCLAW_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "nobody"))
    assert port_loader.read_openclaw_config() == \
        jax_loader.read_openclaw_config() == {}
