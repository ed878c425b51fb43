"""The plan-store CLI twin: ``repro_torch.launch.plan`` against the JAX
package's ``launch/plan.py``.

Both packages specialize the same cells under ``tpu-v5e`` into two plan
directories; the plans have equal content hashes, so the two stores hold
the same artifacts, and every subcommand must print the same text (the
directory's name aside) and return the same exit code.
"""

import json

import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.configs import ShapeConfig as RShape
from repro.launch import plan as rcli
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.launch import plan as tcli

# (arch, shape, options): a paged decode cell and the same cell forced
# dense (so ``diff`` has something to say), an SSM cell and a train cell
CELLS = [("qwen3-8b", ("serve", "decode", 2048, 8), {}),
         ("qwen3-8b", ("serve", "decode", 2048, 8), {"kv_residency": "dense"}),
         ("mamba2-2.7b", ("serve", "decode", 2048, 8), {}),
         ("qwen3-8b", "train_4k", {})]


def _stores(tmp_path):
    """Specialize every cell with both packages; return the two plan
    directories and the hashes (equal in both)."""
    dirs = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    hashes = []
    for arch, shape, opts in CELLS:
        mesh = {} if isinstance(shape, str) else {"mesh_shape": (1, 1)}
        r = rcore.specialize(arch, shape if isinstance(shape, str)
                             else RShape(*shape), target="tpu-v5e",
                             plan_dir=str(dirs["ref"]), **mesh, **opts)
        t = tcore.specialize(arch, shape if isinstance(shape, str)
                             else TShape(*shape), target="tpu-v5e",
                             plan_dir=str(dirs["port"]), **mesh, **opts)
        assert t.content_hash() == r.content_hash(), (arch, shape, opts)
        hashes.append(r.content_hash())
    return dirs, hashes


def _run(capsys, dirs, argv):
    """``(rc, text)`` of each package's CLI, the directory name masked."""
    out = {}
    for name, cli in (("ref", rcli), ("port", tcli)):
        rc = cli.main(["--plan-dir", str(dirs[name]), *argv])
        out[name] = (rc, capsys.readouterr().out.replace(str(dirs[name]),
                                                          "<plan-dir>"))
    return out["ref"], out["port"]


@pytest.mark.parametrize("cmd", ["list", "show", "show --log", "diff",
                                 "diff identical", "verify"])
def test_cli_prints_what_the_reference_prints(tmp_path, capsys, cmd):
    dirs, hashes = _stores(tmp_path)
    argv = {"list": ["list"],
            "show": ["show", hashes[2][:10]],
            "show --log": ["show", hashes[3][:10], "--log"],
            "diff": ["diff", hashes[0][:10], hashes[1][:10]],
            "diff identical": ["diff", hashes[0][:10], hashes[0][:12]],
            "verify": ["verify"]}[cmd]
    ref, port = _run(capsys, dirs, argv)
    assert port == ref
    assert port[1].strip()
    if cmd == "diff":
        assert hashes[0] != hashes[1] and port[0] == 1
    if cmd == "show --log":
        assert "[local_partitioning] tiled_matmul: 512x512x512" in port[1]


def test_cli_verify_fails_the_same_way_on_a_corrupt_entry(tmp_path, capsys):
    dirs, hashes = _stores(tmp_path)
    for d in dirs.values():
        f = d / f"{hashes[0]}.json"
        f.write_text(f.read_text()[:40])            # truncated: corrupt
        e = json.loads((d / f"{hashes[2]}.json").read_text())
        e["plan"]["arch"] = "tampered"              # valid JSON, wrong hash
        (d / f"{hashes[2]}.json").write_text(json.dumps(e))
    ref, port = _run(capsys, dirs, ["verify"])
    assert port == ref
    assert port[0] == 1 and "2 bad" in port[1]
    # list reports the same unreadable entries
    assert _run(capsys, dirs, ["list"])[1] == _run(capsys, dirs, ["list"])[0]


def test_cli_gc_and_unknown_prefix_match(tmp_path, capsys):
    dirs, _ = _stores(tmp_path)
    ref, port = _run(capsys, dirs, ["gc", "--max-entries", "2"])
    assert port[0] == ref[0] == 0
    assert port[1].split(";")[0] == ref[1].split(";")[0] == \
        "gc removed 2 entries"
    for cli, d in ((rcli, dirs["ref"]), (tcli, dirs["port"])):
        assert len(list(d.glob("*.json"))) == 2
        with pytest.raises(SystemExit, match="no stored plan"):
            cli.main(["--plan-dir", str(d), "show", "ffffffffffff"])
