"""The CUDA kernel's wrapper and build, as far as the CPU can check them.

On the CPU, gang_allocate_cuda routes to the plain loop and returns its
results unchanged, launching nothing. The kernel itself runs only on the
card: chip_smoke.py builds it there and holds it against the plain loop.
Here the tests check what surrounds it: that importing the package
compiles nothing, that the ctypes declaration matches the C entry point,
the input validation, and the build's caching by content (with a stand-in
nvcc script).
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from volcano_tpu_torch import convert
from volcano_tpu_torch.ops import build, cuda_allocate
from volcano_tpu_torch.ops.allocate import gang_allocate
from volcano_tpu_torch.ops.cuda_allocate import (check_inputs,
                                                 gang_allocate_cuda)
from volcano_tpu_torch.ops.score import ScoreWeights
from volcano_tpu_torch.utils.synth import synth_arrays

ROOT = Path(__file__).resolve().parent.parent


def _inputs(seed, **kw):
    sa = synth_arrays(120, 40, gang_size=4, seed=seed, **kw)
    t = convert.as_tensors(sa, "cpu")
    w = ScoreWeights.make(4, binpack=1.0)
    return sa, convert.args(t), w


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(n_queues=3)), (2, dict(n_namespaces=3, n_queues=2))])
@pytest.mark.parametrize("allow_pipeline", [True, False])
def test_cpu_tensors_route_to_plain_loop(seed, kw, allow_pipeline):
    _, args, w = _inputs(seed, **kw)
    before = gang_allocate_cuda.launches
    got = gang_allocate_cuda(*args, w, allow_pipeline=allow_pipeline,
                             ns_live=bool(kw))
    want = gang_allocate(*args, w, allow_pipeline=allow_pipeline,
                         ns_live=bool(kw))
    assert gang_allocate_cuda.launches == before
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)


def test_other_devices_raise():
    _, args, w = _inputs(0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gang_allocate_cuda(*meta, w)


def test_importing_the_package_builds_nothing():
    code = ("import sys, volcano_tpu_torch, volcano_tpu_torch.ops, "
            "volcano_tpu_torch.framework, volcano_tpu_torch.cmd.place, "
            "volcano_tpu_torch.ops.cuda_allocate\n"
            "print('volcano_tpu_torch.ops.build' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_ctypes_declaration_matches_c_entry_point():
    src = (ROOT / "volcano_tpu_torch/csrc/gang_allocate.cu").read_text()
    sig = re.search(r"int gang_allocate_launch\((.*?)\)\s*\{", src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    pointers = [p for p in params if "void*" in p]
    ints = [p for p in params if p.startswith("int ")]
    assert len(pointers) + len(ints) == len(params)
    assert params[-1] == "void* stream"
    assert len(pointers) - 1 == cuda_allocate._N_POINTERS
    assert len(ints) == cuda_allocate._N_INTS
    # the wrapper passes the plan's flags and shared bytes last
    assert [p.split()[-1] for p in ints[-4:]] == [
        "blocks", "nodes_per_block", "flags", "shared_bytes"]


def _c_expr(expr, names):
    """A C integer expression of the kernel source, evaluated."""
    return eval(" ".join(expr.split()).replace("/", "//"), {}, dict(names))


def _c_constants():
    src = (ROOT / "volcano_tpu_torch/csrc/gang_allocate.cu").read_text()
    names = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        try:
            names[name] = _c_expr(expr, names)
        except (NameError, SyntaxError):   # K = 2 * kC * B, kRefresh = 0, ..
            pass
    return src, names


def test_cluster_plan_mirrors_the_kernel_layout():
    """The plan's constants are the kernel's, and its shared size is the
    kernel's shared_words for the same arguments, under every plan flag."""
    src, c = _c_constants()
    assert c["kC"] == cuda_allocate.CHUNK
    assert c["kThreads"] == cuda_allocate.THREADS
    assert c["kWarps"] == cuda_allocate.WARPS
    assert c["kDescWords"] == cuda_allocate.DESC_WORDS
    assert c["kMaxStaticR"] == cuda_allocate.MAX_STATIC_R
    assert (c["kNodeGlobal"], c["kFairGlobal"], c["kRowsGlobal"]) == (
        cuda_allocate.NODE_GLOBAL, cuda_allocate.FAIR_GLOBAL,
        cuda_allocate.ROWS_GLOBAL)
    req = re.search(r"constexpr int req_words\(int R\)\s*\{\s*return"
                    r"\s*R > kMaxStaticR \? (\d+) : 2 \* \(R < 8 \? 8 : R\)"
                    r" \+ 6;", src)
    assert req is not None
    for r in (2, 4, 8, 9, 16, 17, 40):
        want = int(req.group(1)) if r > 16 else 2 * max(r, 8) + 6
        assert cuda_allocate.req_words(r) == want
    body = re.search(r"inline long shared_words\(.*?\)\s*\{\s*return(.*?);",
                     src, re.S).group(1)
    for nb, blocks, r, q, ns, p in ((1280, 8, 4, 8, 1, 8),
                                    (640, 16, 8, 3, 2, 6), (8, 8, 2, 1, 1, 1),
                                    (3125, 16, 16, 8, 1, 8),
                                    (128, 16, 40, 64, 64, 512)):
        for flags in range(8):
            g = {f"{k}_g": int(bool(flags & bit)) for k, bit in (
                ("node", cuda_allocate.NODE_GLOBAL),
                ("fs", cuda_allocate.FAIR_GLOBAL),
                ("rows", cuda_allocate.ROWS_GLOBAL))}
            words = _c_expr(body, dict(c, nb=nb, blocks=blocks, R=r, Q=q,
                                       NS=ns, P=p,
                                       req=cuda_allocate.req_words(r), **g))
            assert cuda_allocate.shared_bytes(nb, blocks, r, q, ns, p,
                                              flags) == 4 * words


@pytest.mark.parametrize("r", range(2, 9))
def test_cluster_plan_per_resource_count(r):
    plan = cuda_allocate.cluster_plan(10_240, r, 8, 1, 8)
    assert plan.blocks == 16
    assert plan.nodes_per_block == 640
    assert plan.kind == "shared" and plan.flags == 0
    assert plan.shared_bytes == cuda_allocate.shared_bytes(640, 16, r, 8, 1, 8)
    # 8 blocks while one holds a pass of 512 nodes, else 16
    small = cuda_allocate.cluster_plan(4096, r, 8, 1, 8)
    assert (small.blocks, small.nodes_per_block) == (8, 512)
    assert cuda_allocate.cluster_plan(4097, r, 8, 1, 8).blocks == 16
    assert cuda_allocate.cluster_plan(2100, r, 8, 1, 8).nodes_per_block == 263
    limit = cuda_allocate.node_limit(r, 8, 1, 8)
    assert cuda_allocate.cluster_plan(limit, r, 8, 1, 8).shared_bytes \
        <= cuda_allocate.MAX_SHARED_BYTES
    assert cuda_allocate.cluster_plan(limit, r, 8, 1, 8).kind == "shared"
    # above the shared plan's limit: the global plan, node state in device
    # memory, 16 blocks, within the shared budget
    above = cuda_allocate.cluster_plan(limit + 1, r, 8, 1, 8)
    assert above.kind == "global" and above.blocks == 16
    assert above.flags == cuda_allocate.NODE_GLOBAL
    assert above.shared_bytes <= cuda_allocate.MAX_SHARED_BYTES
    assert above.nodes_per_block == -(-(limit + 1) // 16)
    with pytest.raises(ValueError, match=f"limit of {limit} nodes"):
        cuda_allocate.cluster_plan(limit + 1, r, 8, 1, 8, kind="shared")


def test_node_limit_covers_large_clusters():
    """Kubernetes documents clusters of up to 5,000 nodes; the shared
    plan's limit is far above that and above the 10,240-node north star,
    so the north star keeps the shared plan."""
    assert cuda_allocate.node_limit(4, 8, 1, 8) >= 32_768
    assert cuda_allocate.node_limit(8, 8, 1, 8) >= 16_384
    assert cuda_allocate.cluster_plan(10_240, 4, 8, 1, 8).kind == "shared"


@pytest.mark.parametrize("r", [*range(2, 17), 20])
@pytest.mark.parametrize("qns", [1, 64])
def test_cluster_plan_shared_below_the_limit_global_above(r, qns):
    """Every R and node count gets a plan: the shared plan up to its limit
    (with 1 and 64 queues and namespaces), the global plan above it, both
    within a block's shared memory; the scratch covers the plan's device
    state."""
    q = ns = qns
    p = q * ns
    limit = cuda_allocate.node_limit(r, q, ns, p)
    for n in (1, 2048, limit, limit + 1, 100_000, 250_000):
        plan = cuda_allocate.cluster_plan(n, r, q, ns, p)
        assert plan.kind == ("shared" if n <= limit else "global")
        assert plan.shared_bytes <= cuda_allocate.MAX_SHARED_BYTES
        assert plan.blocks * plan.nodes_per_block >= n
        words = cuda_allocate.scratch_words(plan, r)
        if plan.kind == "global":
            assert plan.blocks == 16
            assert words >= 16 * (3 * r + 4) * plan.nodes_per_block
        assert words >= (r if r > 16 else 1)
    # the global plan can be forced on a shape that fits shared memory
    forced = cuda_allocate.cluster_plan(2048, r, q, ns, p, kind="global")
    assert forced.kind == "global" and forced.blocks == 16
    with pytest.raises(ValueError, match="unknown plan"):
        cuda_allocate.cluster_plan(2048, r, q, ns, p, kind="l2")


def test_cluster_plan_moves_fair_share_and_table_rows_when_they_do_not_fit():
    # fair-share state of (Q + NS) * R + P words beyond a block: device
    plan = cuda_allocate.cluster_plan(10_000, 16, 2000, 2000, 4000)
    assert plan.kind == "global"
    assert plan.flags == cuda_allocate.NODE_GLOBAL | cuda_allocate.FAIR_GLOBAL
    # above R = 16 the table's R-wide rows move out once they do not fit
    wide = cuda_allocate.cluster_plan(2048, 40, 8, 1, 8)
    assert wide.flags & cuda_allocate.ROWS_GLOBAL
    assert wide.shared_bytes <= cuda_allocate.MAX_SHARED_BYTES
    assert cuda_allocate.scratch_words(wide, 40) == (
        16 * 124 * wide.nodes_per_block + 3 * 40 * 32 * 16 + 40)
    # up to R = 16 the table stays in shared memory
    for r in range(2, 17):
        assert not cuda_allocate.cluster_plan(
            500_000, r, 64, 64, 512).flags & cuda_allocate.ROWS_GLOBAL


def test_check_inputs_accepts_the_snapshot_and_rejects_the_rest():
    sa, args, _ = _inputs(0)
    T, G, J, P, NS, N, R, S = check_inputs(args)
    assert (T, N, R, S) == (sa.task_group.shape[0], sa.node_idle.shape[0],
                            4, -1)
    # the slot inputs: both or neither, task_slot [T] i32, slot_ok [S+1, N]
    task_slot = torch.zeros(T, dtype=torch.int32)
    slot_ok = torch.ones(3, N, dtype=torch.bool)
    assert check_inputs(args, task_slot, slot_ok)[-1] == 2
    with pytest.raises(ValueError, match="both or neither"):
        check_inputs(args, task_slot, None)
    with pytest.raises(ValueError, match="task_slot"):
        check_inputs(args, task_slot[:-1], slot_ok)
    with pytest.raises(ValueError, match="slot_ok"):
        check_inputs(args, task_slot, slot_ok[:, :-1])
    with pytest.raises(ValueError, match="slot_ok"):
        check_inputs(args, task_slot, slot_ok.to(torch.uint8))
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(ValueError, match="task_group"):
        check_inputs(bad)
    bad = list(args)
    bad[22] = bad[22].t().contiguous().t()           # node_idle, strided
    with pytest.raises(ValueError, match="node_idle"):
        check_inputs(bad)
    bad = list(args)
    bad[4] = bad[4][:, :-1]                           # group_mask [G, N-1]
    with pytest.raises(ValueError, match="group_mask"):
        check_inputs(bad)
    one_res = [a[..., :1] if a.dim() and a.shape[-1] == 4 else a
               for a in args]
    with pytest.raises(ValueError, match="R=1"):
        check_inputs(one_res)


@pytest.mark.parametrize("r", range(9, 21))
def test_check_inputs_accepts_every_resource_count_above_eight(r):
    sa = synth_arrays(64, 40, gang_size=4, seed=r, r=r)
    args = convert.args(convert.as_tensors(sa, "cpu"))
    assert check_inputs(args)[6] == r


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A csrc/ with one source and an nvcc stand-in that writes its -o
    file and a ptxas line, and logs each call."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "calls.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo call >> {log}\n"
        "echo 'ptxas info    : Used 1 registers'\n"
        "if grep -q FAIL \"$(eval echo \\${$#})\"; then "
        "echo 'error: bad'; exit 2; fi\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
        "echo lib > \"$2\"; fi; shift; done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src, log


def test_build_caches_by_content(fake_toolchain):
    src, log = fake_toolchain
    assert build.sources() == ["k"]
    first = build.build_all()["k"]
    assert first.exists() and first.parent.name == "_build"
    assert "Used 1 registers" in build.report("k")   # kept beside it
    assert build.build("k") == first                # cached: no new call
    assert log.read_text().count("call") == 1
    (src / "k.cu").write_text("// kernel, changed\n")
    second = build.build_all()["k"]
    assert second != first and second.exists()
    assert log.read_text().count("call") == 2
    assert not list(first.parent.glob("*.tmp*"))


def test_build_failure_raises_with_compiler_output(fake_toolchain):
    src, _ = fake_toolchain
    (src / "k.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="error: bad"):
        build.build_all(["k"])
    assert not build.library_path("k").exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_build_flags_target_hopper_without_fma_contraction():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "-shared" in build.NVCC_FLAGS and "-O3" in build.NVCC_FLAGS
