"""The kernel build (``repro_torch.kernels.build``) on the CPU, with a
stand-in for ``nvcc`` that writes its output file and records its
arguments: one compile per source, all started together; a library of
several sources (``PARTS``) compiled to objects, then linked; nothing left
behind but the libraries, and a failed source named."""
from __future__ import annotations

import json
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

FAKE_NVCC = """\
import json, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
if any(a.endswith({fail!r}) for a in args):
    print("error: stand-in failure")
    sys.exit(1)
open(args[args.index("-o") + 1], "w").write("lib")
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def make(fail="no-such-source.cu"):
        log = tmp_path / "calls.jsonl"
        script = tmp_path / "nvcc.py"
        script.write_text(FAKE_NVCC.format(log=str(log), fail=fail))
        exe = tmp_path / "nvcc"
        exe.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
        exe.chmod(0o755)
        monkeypatch.setattr(build, "_nvcc", lambda: str(exe))
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
        return lambda: [json.loads(ln) for ln in log.read_text().splitlines()]
    return make


def test_split_library_compiles_parts_then_links(fake_nvcc):
    calls = fake_nvcc()
    reports = build.build_all(["topk_verify_q", "spec_head"])
    assert set(reports) == {"topk_verify_q", "spec_head"}
    by_src = {a[-1].rsplit("/", 1)[-1]: a for a in calls()
              if a[-1].endswith(".cu")}
    assert set(by_src) == {"topk_verify_q.cu", "topk_verify_q4.cu",
                           "spec_head.cu"}
    for part in ("topk_verify_q.cu", "topk_verify_q4.cu"):
        assert "-c" in by_src[part] and "-shared" not in by_src[part]
    assert "-shared" in by_src["spec_head.cu"] and "-c" not in by_src[
        "spec_head.cu"]
    (link,) = [a for a in calls() if not a[-1].endswith(".cu")]
    assert "-shared" in link and sum(a.endswith(".o") for a in link) == 2
    left = sorted(p.name for p in build.BUILD_DIR.iterdir())
    assert left == sorted(build._lib_path(n).name
                          for n in ("topk_verify_q", "spec_head"))
    assert "Used 1 registers" in reports["topk_verify_q"]
    assert build.build_all(["topk_verify_q", "spec_head"]) == {}


def test_failed_part_is_named_and_leaves_nothing(fake_nvcc):
    fake_nvcc(fail="topk_verify_q4.cu")
    with pytest.raises(RuntimeError, match="topk_verify_q4.cu failed"):
        build.build_all(["topk_verify_q", "spec_head"])
    left = [p.name for p in build.BUILD_DIR.iterdir()]
    assert left == [build._lib_path("spec_head").name]
