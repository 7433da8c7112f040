"""The kernels' build on the CPU side: what names a library, and how the
fault-check tools compile their edited copies. Nothing is compiled here
(there is no nvcc); the tests read hashes and the commands that would
run."""
import importlib.util
import os
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels import build

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture
def csrc(tmp_path):
    """A temporary copy of the kernels' source directory."""
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("name", build.sources())
def test_digest_changes_with_a_shared_header(csrc, name):
    """A library is named by its source and every header of csrc, so an
    edit of hopper.cuh (which K1, K2 and K3 include) rebuilds each
    source."""
    before = build.digest(name, csrc)
    assert build.digest(name, csrc) == before
    assert before == build.digest(name)          # the copy is the source
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.digest(name, csrc) != before


def test_digest_changes_with_a_new_header(csrc):
    before = build.digest("flash_attention", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.digest("flash_attention", csrc) != before


def test_digest_changes_with_the_source(csrc):
    before = build.digest("flash_attention", csrc)
    cu = csrc / "flash_attention.cu"
    cu.write_text(cu.read_text() + "\n")
    assert build.digest("flash_attention", csrc) != before


def _load(script):
    spec = importlib.util.spec_from_file_location(
        script, os.path.join(ROOT, f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Proc:
    returncode = 0

    def communicate(self):
        return "", None


@pytest.mark.parametrize("script", ["k1_fault_check", "k2_fault_check",
                                    "k3_fault_check", "k4_fault_check"])
def test_fault_tools_include_each_trees_headers(script, monkeypatch,
                                                tmp_path):
    """The tools build edited copies in a temporary directory, where
    `#include "hopper.cuh"` resolves only through `-I` at the tree's own
    csrc: this checkout's for its variants, a second tree's for it."""
    mod = _load(script)
    k1 = _load("k1_fault_check")
    cmds = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd) or _Proc())
    monkeypatch.setattr(k1.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    other = tmp_path / "parent"
    shutil.copytree(build.CSRC, other / k1.csrc(""))
    variant = sorted(mod.EDITS)[0]
    libs = k1.build_trees(str(tmp_path), {"change": k1.ROOT,
                                          "parent": str(other)},
                          {"v": f"change:{variant}"}, cu=mod.CU,
                          edits=mod.EDITS)
    assert sorted(libs) == ["change", "parent", "v"]
    inc = {cmd[-1].rsplit("/", 1)[-1]: cmd[cmd.index("-I") + 1]
           for cmd in cmds}
    here = os.path.normpath(os.path.join(k1.ROOT, k1.csrc("")))
    assert os.path.normpath(inc["change.cu"]) == here
    assert os.path.normpath(inc["v.cu"]) == here
    assert os.path.normpath(inc["parent.cu"]) == os.path.normpath(
        str(other / k1.csrc("")))
