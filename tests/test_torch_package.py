"""The port's package contract on a machine without a GPU or nvcc.

  * ``import mojo_opset_tpu_torch`` loads neither jax nor mojo_opset_tpu;
  * every kernel module imports without nvcc;
  * a cuda-tier op on CPU tensors runs its kernel's plain version and
    launches nothing;
  * a kernel wrapper given a non-CPU tensor never falls back: it checks its
    input and builds, and without nvcc the build raises;
  * dispatch (MOJO_BACKEND), the allocator's errors and the refused quant
    modes;
  * the entry points (models, session) and the ops that hold parameters
    or tables run on the card unless the caller names a device: here, with
    no GPU, they raise instead of landing on the CPU.
"""

import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import build, kernels
from mojo_opset_tpu_torch.backends.cuda.functions import FlceVJP
from mojo_opset_tpu_torch.backends.cuda.kernels import (
    conv1d_vjp,
    flash_diffusion,
    flash_swa,
    flce,
    group_gemm,
    group_quant_gemm,
    int4_matmul,
    int8_matmul,
    mla_decode,
    norms,
    paged_decode,
    paged_prefill,
    rmsnorm_quant,
    rmsnorm_vjp,
    rope,
    rope_head_first,
    silu_vjp,
)
from mojo_opset_tpu_torch.core.registry import BackendNotAvailable
from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3Config, DeepseekV3ForCausalLM, MLARuntimeState
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3MoeConfig, Qwen3MoeForCausalLM
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel
from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel, PagedAttentionRuntimeState
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.platform import resolve_device

REPO = Path(__file__).resolve().parents[1]
KERNEL_MODULES = ["norms", "rope", "paged_decode", "paged_prefill", "rmsnorm_quant", "int8_matmul", "int4_matmul",
                  "group_gemm", "mla_decode", "rmsnorm_vjp", "rope_head_first", "flash_swa", "silu_vjp", "flce",
                  "flash_diffusion", "conv1d_vjp", "group_quant_gemm"]
# the counters of the entry points beside the single-entry modules' own (norms holds A's and P's)
MULTI_ENTRY = {"flash_swa_fwd", "flash_swa_dq", "flash_swa_dkv", "silu_fwd", "silu_bwd", "flce_stats", "flce_dz",
               "flce_dx", "flce_dw", "flash_diffusion_fwd", "flash_diffusion_dq", "flash_diffusion_dkv",
               "residual_add_rmsnorm", "conv1d_fwd", "conv1d_bwd"}


def test_import_loads_no_jax():
    code = (
        "import sys, mojo_opset_tpu_torch, mojo_opset_tpu_torch.modeling.qwen3, mojo_opset_tpu_torch.runtime\n"
        "import mojo_opset_tpu_torch.core.operators.moe, mojo_opset_tpu_torch.backends.cuda.operators.moe\n"
        "import mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3_moe, mojo_opset_tpu_torch.backends.cuda.kernels\n"
        "import mojo_opset_tpu_torch.modeling.deepseekv3, mojo_opset_tpu_torch.backends.cuda.operators.mla\n"
        "import mojo_opset_tpu_torch.modeling.seed_oss, mojo_opset_tpu_torch.backends.cuda.functions\n"
        "import mojo_opset_tpu_torch.modeling.wan2_2, mojo_opset_tpu_torch.benchmark.dit_protocol\n"
        "import mojo_opset_tpu_torch.experimental.functions, mojo_opset_tpu_torch.core.operators.convolution\n"
        "import mojo_opset_tpu_torch.core.operators.mlp, mojo_opset_tpu_torch.backends.cuda.functions.convolution\n"
        "import mojo_opset_tpu_torch.parallel, mojo_opset_tpu_torch.core.operators.compute_with_comm\n"
        "import mojo_opset_tpu_torch.runtime.comm_context, mojo_opset_tpu_torch.runtime.parallel\n"
        "import mojo_opset_tpu_torch.utils.debugger, mojo_opset_tpu_torch.utils.tracing\n"
        "import mojo_opset_tpu_torch.utils.profiler, mojo_opset_tpu_torch.runtime.native\n"
        "import mojo_opset_tpu_torch.examples.llm_inference, mojo_opset_tpu_torch.examples.continuous_serving\n"
        "import mojo_opset_tpu_torch.examples.dit_inference\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'mojo_opset_tpu'"
        " or m.startswith('mojo_opset_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


# the HF glue, the generator surface and deterministic mode: the card has neither transformers nor safetensors
HF_SURFACE_MODULES = ["utils.hf", "utils.patching", "utils.platform", "runtime.config", "runtime.generation",
                      "runtime", "backends", "examples.llm_inference", "examples.dit_inference",
                      "examples.qwen3_patch"]


def test_hf_surface_imports_load_no_jax_transformers_or_safetensors():
    """Each module imported in turn in one fresh interpreter, the loaded
    modules checked after each import (none of the four may load before)."""
    code = (
        "import importlib, sys\n"
        f"for name in {HF_SURFACE_MODULES!r}:\n"
        "    importlib.import_module('mojo_opset_tpu_torch.' + name)\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                 ('jax', 'mojo_opset_tpu', 'transformers', 'safetensors', 'tokenizers'))\n"
        "    assert not bad, (name, bad[:5])\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, timeout=120, capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_modules_import_without_nvcc(name):
    module = importlib.import_module(f"mojo_opset_tpu_torch.backends.cuda.kernels.{name}")
    assert isinstance(module.launches, int)
    assert (build.CSRC_DIR / "common.cuh").exists()
    assert {p.stem for p in build.sources() if p.suffix == ".cu"} == {
        "rmsnorm", "rope", "paged_decode", "paged_prefill", "rmsnorm_quant", "int8_matmul", "int4_matmul",
        "group_gemm", "mla_decode", "flash_swa", "rmsnorm_vjp", "silu", "rope_head_first", "flce", "flash_diffusion",
        "conv1d", "group_quant_gemm"}


def _cpu_calls():
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    table = torch.tensor([[2, 0, -1], [1, 3, 4]], dtype=torch.int32)
    kc, vc = t(5, 4, 2, 64), t(5, 4, 2, 64)  # NHD, block size 4
    hn, rn = t(3, 64), t(3, 64)
    yield ("norms", lambda: (tm.MojoRMSNorm.get_backend_impl("cuda")(64, device="cpu")(t(3, 64)),
                             *tm.MojoResidualAddRMSNorm.get_backend_impl("cuda")(64, norm_pos="post", device="cpu")(
                                 hn, rn)), None)
    q, k, cos, sin = t(5, 4, 64), t(5, 2, 64), t(5, 64), t(5, 64)
    yield ("rope", lambda: tm.MojoApplyRoPE.get_backend_impl("cuda")()(q, k, cos, sin, head_first=False),
           lambda: rope.rope_token_first_plain(q, k, cos, sin))
    qd, lens = t(2, 8, 64), torch.tensor([6, 9], dtype=torch.int32)
    yield ("paged_decode",
           lambda: tm.MojoPagedDecodeGQA.get_backend_impl("cuda")(kv_layout="NHD")(qd, kc, vc, lens, table),
           lambda: tm.MojoPagedDecodeGQA.get_backend_impl("ref")(kv_layout="NHD")(qd, kc, vc, lens, table))
    qp, cu = t(7, 8, 64), torch.tensor([0, 3, 7], dtype=torch.int32)
    cu_kv = torch.tensor([0, 6, 15], dtype=torch.int32)
    yield ("paged_prefill",
           lambda: tm.MojoPagedPrefillGQA.get_backend_impl("cuda")(kv_layout="NHD")(
               qp, kc, vc, cu, table, None, cu_kv, max_q_len=4),
           lambda: tm.MojoPagedPrefillGQA.get_backend_impl("ref")(kv_layout="NHD")(qp, kc, vc, cu, table, None, cu_kv))
    x = t(3, 64)
    yield ("rmsnorm_quant", lambda: tm.MojoRMSNormQuant.get_backend_impl("cuda")(64, device="cpu")(x),
           lambda: tm.MojoRMSNormQuant.get_backend_impl("ref")(64, device="cpu")(x))
    xq = torch.from_numpy(rng.integers(-128, 128, (3, 64)).astype(np.int8))
    xs = torch.from_numpy(rng.random((3, 1)).astype(np.float32))
    yield ("int8_matmul",
           lambda: tm.MojoQuantGemm.get_backend_impl("cuda")(64, 32, trans_weight=True, device="cpu")(xq, xs),
           lambda: tm.MojoQuantGemm.get_backend_impl("ref")(64, 32, trans_weight=True, device="cpu")(xq, xs))
    yield ("int4_matmul",
           lambda: tm.MojoQuantGemm.get_backend_impl("cuda")(64, 128, trans_weight=True, weight_dtype="int4",
                                                              device="cpu")(xq, xs),
           lambda: int4_matmul.int4_scaled_matmul_plain(xq, torch.zeros(64, 64, dtype=torch.int8), xs,
                                                        torch.ones(128), torch.bfloat16))
    w, xg, counts = t(3, 16, 64), t(7, 64), torch.tensor([2, 0, 5], dtype=torch.int32)
    yield ("group_gemm", lambda: tm.MojoGroupGemm.get_backend_impl("cuda")(w, trans_weight=True)(xg, counts),
           lambda: tm.MojoGroupGemm.get_backend_impl("ref")(w, trans_weight=True)(xg, counts))
    c, pe, qm = t(5, 1, 4, 32), t(5, 1, 4, 16), t(2, 4, 48)  # latent 32, rope 16, 4 heads, nope 32
    mla_op = tm.MojoPagedDecodeMLA.get_backend_impl("cuda")(4, 32, 16, 32, 32, device="cpu")
    mla_plain = tm.MojoPagedDecodeMLA.get_backend_impl("cuda")(4, 32, 16, 32, 32, device="cpu")
    mla_plain.kv_b_proj.data.copy_(mla_op.kv_b_proj)
    mla_plain.attend = mla_decode.mla_decode_absorbed_plain
    yield "mla_decode", lambda: mla_op(qm, c, pe, lens, table), lambda: mla_plain(qm, c, pe, lens, table)
    qs, ks, cu_s = t(9, 4, 64), t(9, 2, 64), torch.tensor([0, 4, 9], dtype=torch.int32)
    xn, wn, dyn = t(5, 64), t(64), t(5, 64)
    yield ("rmsnorm_vjp", lambda: rmsnorm_vjp.rmsnorm_bwd(xn, wn, dyn, 1e-6),
           lambda: rmsnorm_vjp.rmsnorm_bwd_plain(xn, wn, dyn, 1e-6))
    qh, kh, ch, sh = t(2, 4, 5, 64), t(2, 2, 5, 64), t(5, 64), t(5, 64)
    yield ("rope_head_first", lambda: tm.MojoApplyRoPE.get_backend_impl("cuda")()(qh, kh, ch, sh, head_first=True),
           lambda: rope_head_first.rope_head_first_plain(qh, kh, ch, sh))
    yield ("flash_swa", lambda: tm.MojoSWAFunction.get_backend_impl("cuda")(local_window_size=2)(qs, ks, ks, cu_s, cu_s),
           lambda: flash_swa.flash_swa_fwd_plain(qs, ks, ks, cu_s, cu_s, local_window=2)[0])
    xs_ = t(3, 100)
    yield ("silu_vjp", lambda: (silu_vjp.silu_fwd(xs_), silu_vjp.silu_bwd(xs_, xs_)),
           lambda: (silu_vjp.silu_fwd_plain(xs_), silu_vjp.silu_bwd_plain(xs_, xs_)))
    xl, wl, tl = t(6, 64), t(40, 64), torch.tensor([3, -100, 39, 0, 7, 7])
    options = (-100, 0.0, 0.0, "mean", None)
    yield ("flce", lambda: tm.MojoFusedLinearCrossEntropyFunction.get_backend_impl("cuda")()(xl, wl, tl),
           lambda: FlceVJP.apply(xl, wl, tl, options, flce.flce_stats_plain, flce.flce_backward_plain)[0])
    qo, ko, mo = t(1, 4, 9, 64), t(1, 2, 9, 64), torch.from_numpy(rng.random((9, 9)) < 0.5)
    yield ("flash_diffusion",
           lambda: tm.MojoDiffusionAttentionFunction.get_backend_impl("cuda")()(qo, ko, ko, mo, 0.2, True),
           lambda: flash_diffusion.flash_diffusion_fwd_plain(qo, ko, ko, mo, 0.2)[0])
    xc, wc, sc = t(2, 9, 16), t(16, 4), t(2, 16, 3)
    yield ("conv1d_vjp",
           lambda: tm.MojoCausalConv1dFunction.get_backend_impl("cuda")()(xc, wc, None, None, sc, True, "silu"),
           lambda: (conv1d_vjp.conv1d_fwd_plain(xc, wc, None, sc.transpose(1, 2), True),
                    torch.cat([sc, xc.transpose(1, 2)], -1)[..., -3:]))
    qe = tm.MojoQuantExperts.get_backend_impl("cuda")(3, 64, 32, up_weight_dtype="int4", device="cpu")
    qe_ref = tm.MojoQuantExperts.get_backend_impl("ref")(3, 64, 32, up_weight_dtype="int4", device="cpu")
    for stack in (qe.up_proj_weight, qe.down_proj_weight):
        stack.copy_(torch.from_numpy(rng.integers(-128, 128, stack.shape).astype(np.int8)))
    qe_ref.load_state_dict(qe.state_dict())
    yield ("group_quant_gemm", lambda: qe(xg, counts), lambda: qe_ref(xg, counts))


@pytest.mark.parametrize("case", list(_cpu_calls()), ids=KERNEL_MODULES)
def test_cuda_tier_on_cpu_runs_plain_version(case):
    name, run, plain = case
    kernels.reset_launch_counts()
    out = run()
    if plain is not None:
        check_tol_diff(out, plain(), atol=0.0, rtol=0.0)
    counts = kernels.launch_counts()
    assert set(counts) == (set(KERNEL_MODULES) - {"flash_swa", "silu_vjp", "flce", "flash_diffusion", "conv1d_vjp"}
                           ) | MULTI_ENTRY
    assert set(counts.values()) == {0}, name


def test_find_nvcc_raises_without_toolkit(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_raises_without_nvcc_and_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()
    assert build.library_path().name.startswith("libmojo_kernels-")


def test_entry_point_signatures_match_the_sources():
    """ctypes passes what build.SIGNATURES says: each C entry point's
    parameters, in order, as pointer, int, int64 or float."""
    import re

    kinds = {"int": "int", "float": "float", "long long": "int64", "int64_t": "int64"}
    found = {}
    for src in build.CSRC_DIR.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [
                "pointer" if "*" in p else kinds[" ".join(p.split()[:-1]).replace("const ", "")]
                for p in params.split(",")
            ]
    ctype = {build._P: "pointer", build._I: "int", build._L: "int64", build._F: "float"}
    assert set(found) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert [ctype[t] for t in argtypes] == found[name], name


def test_library_hash_follows_the_sources(monkeypatch, tmp_path):
    before = build.library_path().name
    (tmp_path / "extra.cu").write_text("// changed\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path().name != before


def test_kernel_path_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel: without a build it raises
    instead of running the plain version."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernels built"):
        norms.rmsnorm(x, torch.empty(64, device="meta"), 1e-6)
    assert norms.launches == 0


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    table, lens = meta(2, 3, dtype=torch.int32), meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):  # 16, 80, 96 are taken, padded; 8 is not a 16-byte row of int8
        paged_decode.paged_decode_gqa(meta(2, 8, 8), meta(5, 4, 2, 8), meta(5, 4, 2, 8), lens, table)
    with pytest.raises(ValueError, match="multiple of kv heads"):  # any group is taken (32/1 in test_torch_paged_decode)
        paged_decode.paged_decode_gqa(meta(2, 12, 64), meta(5, 8, 4, 64), meta(5, 8, 4, 64), lens, table)
    with pytest.raises(ValueError, match="share one dtype"):
        paged_decode.paged_decode_gqa(meta(2, 8, 64, dtype=torch.float32), meta(5, 2, 4, 64),
                                      meta(5, 2, 4, 64), lens, table)
    with pytest.raises(ValueError, match="max_q_len"):
        paged_prefill.paged_prefill_gqa(meta(7, 8, 64), meta(5, 2, 4, 64), meta(5, 2, 4, 64),
                                        meta(3, dtype=torch.int32), table)
    with pytest.raises(ValueError, match="causal"):
        paged_prefill.paged_prefill_gqa(meta(7, 8, 64), meta(5, 2, 4, 64), meta(5, 2, 4, 64),
                                        meta(3, dtype=torch.int32), table, is_causal=False, max_q_len=4)
    with pytest.raises(ValueError, match="float32"):
        norms.rmsnorm(meta(3, 64), meta(64), 1e-6)
    with pytest.raises(ValueError, match="full-rope"):
        rope.rope_token_first(meta(5, 4, 64), meta(5, 2, 64), meta(5, 32), meta(5, 32))
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        norms.rmsnorm(meta(3, 64, dtype=torch.float64), meta(64, dtype=torch.float32), 1e-6)
    with pytest.raises(ValueError, match="local_window"):
        paged_decode.paged_decode_gqa(meta(2, 8, 64), meta(5, 4, 2, 64), meta(5, 4, 2, 64), lens, table,
                                      local_window=-2)


def test_training_kernel_wrappers_reject_what_the_kernels_do_not_take():
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    with pytest.raises(ValueError, match="float32"):
        rmsnorm_vjp.rmsnorm_bwd(meta(3, 64), meta(64), meta(3, 64), 1e-6)
    with pytest.raises(ValueError, match="dy must match x"):
        rmsnorm_vjp.rmsnorm_bwd(meta(3, 64), meta(64, dtype=torch.float32), meta(3, 64, dtype=torch.float16), 1e-6)
    with pytest.raises(ValueError, match="D <="):
        rmsnorm_vjp.rmsnorm_bwd(meta(3, 50000), meta(50000, dtype=torch.float32), meta(3, 50000), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_vjp.rmsnorm_bwd(meta(64, 3).t(), meta(64, dtype=torch.float32), meta(64, 3).t(), 1e-6)
    with pytest.raises(ValueError, match="dy must match x"):
        silu_vjp.silu_bwd(meta(3, 64), meta(3, 32))
    with pytest.raises(ValueError, match="contiguous"):
        silu_vjp.silu_fwd(meta(64, 3).t())
    with pytest.raises(ValueError, match="share one dtype"):
        rope_head_first.rope_head_first(meta(1, 4, 3, 64), meta(1, 2, 3, 64, dtype=torch.float16), meta(3, 64),
                                        meta(3, 64))
    with pytest.raises(ValueError, match="full-rope"):
        rope_head_first.rope_head_first(meta(1, 4, 3, 64), meta(1, 2, 3, 64), meta(3, 32), meta(3, 32))
    with pytest.raises(ValueError, match="q's dtype or float32"):
        rope_head_first.rope_head_first(meta(1, 4, 3, 64), meta(1, 2, 3, 64), meta(3, 64, dtype=torch.float16),
                                        meta(3, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="unit stride on D"):
        rope_head_first.rope_head_first(meta(1, 4, 64, 3).transpose(-1, -2), meta(1, 2, 3, 64), meta(3, 64),
                                        meta(3, 64))
    t32 = meta(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="H must be a multiple of 8"):
        flce.flce_stats(meta(3, 60), meta(10, 60), t32)
    with pytest.raises(ValueError, match="share one dtype"):
        flce.flce_stats(meta(3, 64), meta(10, 64, dtype=torch.float16), t32)
    with pytest.raises(ValueError, match="contiguous int32"):
        flce.flce_stats(meta(3, 64), meta(10, 64), meta(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="row pitch"):
        flce.flce_dx(meta(3, 13), meta(13, 64))
    assert rmsnorm_vjp.launches == silu_vjp.launches == silu_vjp.launches_bwd == rope_head_first.launches == 0
    assert flce.launches == flce.launches_dx == 0


def test_training_kernels_never_fall_back(monkeypatch):
    """The training Functions send a tensor off the CPU to kernels A, K, L,
    M and N: without a build they raise instead of running the plain
    version."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    calls = [lambda: tm.MojoRMSNormFunction.get_backend_impl("cuda")()(meta(3, 64), meta(64)),
             lambda: tm.MojoSiluFunction.get_backend_impl("cuda")()(meta(3, 64)),
             lambda: tm.MojoApplyRoPEFunction.get_backend_impl("cuda")()(meta(1, 3, 4, 64), meta(1, 3, 2, 64),
                                                                           meta(3, 64), meta(3, 64), head_first=False),
             lambda: rmsnorm_vjp.rmsnorm_bwd(meta(3, 64), meta(64), meta(3, 64), 1e-6),
             lambda: silu_vjp.silu_bwd(meta(3, 64), meta(3, 64)),
             lambda: tm.MojoFusedLinearCrossEntropyFunction.get_backend_impl("cuda")()(
                 meta(3, 64), meta(10, 64), torch.empty(3, device="meta", dtype=torch.int64))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no kernels built"):
            call()
    assert set(kernels.launch_counts().values()) == {0}


def test_int8_kernel_wrappers_reject_what_the_kernels_do_not_take():
    meta = lambda *shape, dtype=torch.int8: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    f32 = torch.float32
    table, lens = meta(2, 3, dtype=torch.int32), meta(2, dtype=torch.int32)
    q, cache = meta(2, 8, 64, dtype=torch.bfloat16), meta(5, 2, 4, 64)
    with pytest.raises(ValueError, match="share one dtype"):  # int8 pages without scales
        paged_decode.paged_decode_gqa(q, cache, cache, lens, table)
    with pytest.raises(ValueError, match="contiguous float32"):
        paged_decode.paged_decode_gqa(q, cache, cache, lens, table, key_scale=meta(2, 64, dtype=torch.bfloat16),
                                      value_scale=meta(2, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="K % 16"):
        int8_matmul.int8_scaled_matmul(meta(4, 40), meta(32, 40), meta(4, dtype=f32), meta(32, dtype=f32), True,
                                       torch.bfloat16)
    with pytest.raises(ValueError, match="N % 16"):
        int8_matmul.int8_scaled_matmul(meta(4, 64), meta(64, 40), meta(4, dtype=f32), meta(40, dtype=f32), False,
                                       torch.bfloat16)
    with pytest.raises(ValueError, match="input_scale"):
        int8_matmul.int8_scaled_matmul(meta(4, 64), meta(32, 64), meta(4, dtype=torch.bfloat16),
                                       meta(32, dtype=f32), True, torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 8192"):
        rmsnorm_quant.rmsnorm_quant(meta(2, 8200, dtype=f32), meta(8200, dtype=f32), 1e-6)


def test_group_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    counts = meta(4, dtype=torch.int32)
    gmm = group_gemm.grouped_matmul
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        gmm(meta(8, 64, dtype=torch.float64), meta(4, 32, 64, dtype=torch.float64), counts, True)
    with pytest.raises(ValueError, match="share one dtype"):
        gmm(meta(8, 64), meta(4, 32, 64, dtype=torch.float16), counts, True)
    with pytest.raises(ValueError, match="do not match"):
        gmm(meta(8, 64), meta(4, 64, 32), counts, True)  # a (G, K, N) weight given as (G, N, K)
    with pytest.raises(ValueError, match="2-D"):
        gmm(meta(2, 8, 64), meta(4, 32, 64), counts, True)
    with pytest.raises(ValueError, match="contiguous"):
        gmm(meta(64, 8).t(), meta(4, 32, 64), counts, True)
    with pytest.raises(ValueError, match="contiguous"):
        gmm(meta(8, 64), meta(4, 64, 32).transpose(1, 2), counts, True)
    with pytest.raises(ValueError, match="int32"):
        gmm(meta(8, 64), meta(4, 32, 64), meta(4, dtype=torch.int64), True)
    with pytest.raises(ValueError, match="int32"):
        gmm(meta(8, 64), meta(4, 32, 64), meta(3, dtype=torch.int32), True)
    with pytest.raises(ValueError, match="K % 8"):
        gmm(meta(8, 60), meta(4, 32, 60), counts, True)
    with pytest.raises(ValueError, match="N % 8"):
        gmm(meta(8, 64), meta(4, 64, 36), counts, False)
    assert group_gemm.launches == 0


def test_mla_wrapper_rejects_what_the_kernel_does_not_take():
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    lens, table = meta(2, dtype=torch.int32), meta(2, 3, dtype=torch.int32)
    c, pe = meta(5, 1, 64, 512), meta(5, 1, 64, 64)
    mla = mla_decode.mla_decode_absorbed
    f32 = lambda *shape: meta(*shape, dtype=torch.float32)  # noqa: E731
    with pytest.raises(ValueError, match="r <= 512"):  # the fp32 scalar kernel; bf16 takes r 640
        mla(f32(2, 16, 640), f32(2, 16, 64), f32(5, 1, 64, 640), f32(5, 1, 64, 64), lens, table)
    with pytest.raises(ValueError, match="r <= 512"):  # fp32 r + dr > 576
        mla(f32(2, 16, 512), f32(2, 16, 128), f32(5, 1, 64, 512), f32(5, 1, 64, 128), lens, table)
    with pytest.raises(ValueError, match="shared memory"):  # bf16: the tile and one stage past 227 KB
        mla(meta(2, 16, 1024), meta(2, 16, 128), meta(5, 1, 64, 1024), meta(5, 1, 64, 128), lens, table)
    with pytest.raises(ValueError, match="16-byte rows"):
        mla(meta(2, 16, 500), meta(2, 16, 64), meta(5, 1, 64, 500), pe, lens, table)
    with pytest.raises(ValueError, match="share one dtype"):
        mla(meta(2, 16, 512, dtype=torch.float32), meta(2, 16, 64, dtype=torch.float32), c, pe, lens, table)
    with pytest.raises(ValueError, match="do not match"):
        mla(meta(2, 16, 512), meta(2, 8, 64), c, pe, lens, table)
    with pytest.raises(ValueError, match="row_lens"):
        mla(meta(2, 16, 512), meta(2, 16, 64), c, pe, meta(2, dtype=torch.int64), table)
    with pytest.raises(ValueError, match="one table row per query row"):
        mla(meta(3, 16, 512), meta(3, 16, 64), c, pe, meta(3, dtype=torch.int32), table)
    with pytest.raises(ValueError, match="sink"):
        mla(meta(2, 16, 512), meta(2, 16, 64), c, pe, lens, table, sink=meta(16))
    with pytest.raises(ValueError, match="contiguous"):
        mla(meta(16, 2, 512).transpose(0, 1), meta(2, 16, 64), c, pe, lens, table)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        mla(meta(2, 16, 512, dtype=torch.float64), meta(2, 16, 64), c, pe, lens, table)
    assert mla_decode.launches == 0


def test_mla_ops_never_fall_back(monkeypatch):
    """The cuda-tier MLA ops send every non-CPU tensor to kernel I, the sink
    and the prefill row mode included: without a build they raise."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    c, pe, table = meta(5, 1, 16, 32), meta(5, 1, 16, 16), meta(2, 3, dtype=torch.int32)
    decode = tm.MojoPagedDecodeMLA.get_backend_impl("cuda")(4, 32, 16, 32, 32, use_attn_sink=True, device="meta")
    with pytest.raises(RuntimeError, match="no kernels built"):
        decode(meta(2, 4, 48), c, pe, meta(2, dtype=torch.int32), table)
    prefill = tm.MojoPagedPrefillMLA.get_backend_impl("cuda")(4, 32, 16, 32, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernels built"):
        prefill(meta(7, 4, 48), c, pe, meta(3, dtype=torch.int32), table)
    assert mla_decode.launches == 0


def test_resolve_device_defaults_to_the_card(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("meta")) == torch.device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)


def test_entry_points_without_a_device_never_land_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen3ForCausalLM(_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen3MoeForCausalLM(Qwen3MoeConfig(**_TINY, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
                                           dtype=torch.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedAttentionRuntimeState(_tiny().to_mojo(), batch_size=1)
    deepseek = DeepseekV3Config(hidden_size=32, intermediate_size=64, moe_intermediate_size=16, num_attention_heads=2,
                                num_hidden_layers=2, vocab_size=64, max_position_embeddings=32, q_lora_rank=16,
                                kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8,
                                n_routed_experts=4, num_experts_per_tok=2, first_k_dense_replace=1,
                                dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepseekV3ForCausalLM(deepseek)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLARuntimeState(deepseek.to_mojo(), batch_size=1)
    assert MLARuntimeState.from_model(DeepseekV3ForCausalLM(deepseek, device="cpu"), 1).device.type == "cpu"
    session = PagedAttentionRuntimeState(_tiny().to_mojo(), batch_size=1, device="cpu")
    assert session.caches.key(0).device.type == "cpu"
    model = Qwen3ForCausalLM(_tiny(), device="cpu")
    assert PagedAttentionRuntimeState.from_model(model, 1).device.type == "cpu"
    wan = dict(dim=32, ffn_dim=64, num_heads=2, num_layers=1, text_dim=16, freq_dim=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WanModel(WanConfig(**wan))
    assert WanModel(WanConfig(**wan), device="cpu").patch_weight.device.type == "cpu"
    # the ops that hold parameters or tables, built on their own
    ops = ((tm.MojoResidualAddRMSNorm, 8), (tm.MojoResidualAddLayerNorm, 8), (tm.MojoResidualAddRMSNormQuant, 8),
           (tm.MojoResidualAddLayerNormQuant, 8), (tm.MojoGroupRMSNorm, 2, 8, 1e-6), (tm.MojoLayerNormQuant, 8),
           (tm.MojoRMSNorm, 8), (tm.MojoLayerNorm, 8), (tm.MojoRMSNormQuant, 8), (tm.MojoRotaryEmbedding, 1e4, 8),
           (tm.MojoVisionRotaryEmbedding2D,), (tm.MojoSwiGLUMLP, 8, 8, 16), (tm.MojoGemm, 8, 8),
           (tm.MojoQuantGemm, 8, 8), (tm.MojoStaticQuant, 8), (tm.MojoDynamicQuant, 8), (tm.MojoEmbedding, 8, 8),
           (tm.MojoMoEGating, 8, 4, 2), (tm.MojoExperts, 4, 8, 16), (tm.MojoPagedDecodeMLA, 2, 8, 8, 8, 16),
           (tm.MojoQuantExperts, 4, 16, 16), (tm.MojoQuantMoE, 4, 2, 16, 16), (tm.MojoMoEDynamicQuant, 4, 8),
           (tm.MojoDequantSwiGLUQuant, 4, 8))
    for op, *args in ops:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            op(*args)
        held = [*op(*args, device="cpu").parameters(), *op(*args, device="cpu").buffers()]
        assert held and all(t.device.type == "cpu" for t in held), op
    assert tm.MojoRotaryEmbedding(1e4, 8, init_max_length=16, device="cpu").cos.device.type == "cpu"
    # the example entry points: the card unless --device names another
    from mojo_opset_tpu_torch.examples import continuous_serving, dit_inference, llm_inference

    for example, argv in ((llm_inference, ["--tiny"]), (continuous_serving, []), (dit_inference, ["--layers", "1"])):
        with pytest.raises(RuntimeError, match="pass --device cpu"):
            example.main(argv)


def test_dispatch_follows_mojo_backend(monkeypatch):
    assert type(tm.MojoRMSNorm(8, device="cpu")).__name__ == "CudaRMSNorm"
    assert type(tm.MojoGemm(4, 4, device="cpu")).__name__ == "RefGemm"
    monkeypatch.setenv("MOJO_BACKEND", "ref")
    assert type(tm.MojoRMSNorm(8, device="cpu")).__name__ == "RefRMSNorm"
    monkeypatch.setenv("MOJO_BACKEND", "no_such_tier")
    assert type(tm.MojoPagedDecodeGQA()).__name__ == "CudaPagedDecodeGQA"
    with pytest.raises(BackendNotAvailable):
        tm.MojoGemm.get_backend_impl("cuda", strict=True)


def test_forward_diff_with_compares_tiers():
    x = torch.randn(3, 16)
    cuda_op = tm.MojoRMSNorm.get_backend_impl("cuda")(16, device="cpu")
    ref_op = tm.MojoRMSNorm.get_backend_impl("ref")(16, device="cpu")
    out = cuda_op.forward_diff_with(ref_op, x, atol=1e-6, rtol=1e-6)
    assert out.shape == x.shape
    with pytest.raises(NotImplementedError):
        ref_op.forward_diff_with(tm.MojoRMSNorm.get_backend_impl("ref")(16, device="cpu"), x)


_TINY = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=1, head_dim=8, vocab_size=64, max_position_embeddings=32)


def _tiny(**kw):
    return Qwen3Config(**_TINY, dtype=torch.float32, **kw)


def test_quant_modes_are_not_ported_yet():
    """w8a8, w4a8 and the C8 cache are ported; other modes are refused."""
    # no width of this model fills a 128-channel group, so its w4a8 projections all stay int8
    attn = Qwen3ForCausalLM(_tiny(quant="w4a8"), device="cpu").model.layers[0].self_attn
    assert attn.q_proj.weight_dtype == attn.o_proj.weight_dtype == torch.int8
    with pytest.raises(ValueError, match="w8a8"):
        _tiny(quant="fp8")
    assert _tiny(quant="w8a8", quant_kv=True).to_mojo().model_config.kv_layout == "HND"


def test_session_errors_and_device_tokens():
    model = Qwen3ForCausalLM(_tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    gm = PagedAttentionGenerationModel(model, block_size=8)
    logits, session = gm(np.arange(1, 6, dtype=np.int32), context_input_len=np.array([5], np.int32))
    assert isinstance(session, PagedAttentionRuntimeState) and session.caches.key(0).shape == (4, 8, 2, 8)
    with pytest.raises(ValueError, match="exactly one token"):
        gm(torch.tensor([1, 2], dtype=torch.int32), session=session)
    token = torch.argmax(logits, -1).to(torch.int32)  # stays a tensor: no host round trip
    logits, session = gm(token, session=session)
    assert session.total_seq_lens.tolist() == [6] and torch.isfinite(logits).all()
    session.release_sequence(0)
    assert session.free_block_count() == 4
    session._allocate_blocks(3)
    with pytest.raises(ValueError, match="Out of paged KV cache memory"):
        gm(np.ones(9, np.int32), context_input_len=np.array([9], np.int32), session=session)


def test_random_init_is_seeded_and_scaled():
    a = Qwen3ForCausalLM(_tiny(), device="cpu", generator=torch.Generator().manual_seed(3))
    b = Qwen3ForCausalLM(_tiny(), device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.model.layers[0].mlp.down_proj.weight
    assert w.abs().max() <= 1 / math.sqrt(64)
    assert torch.equal(a.model.norm.weight, torch.ones(32))


def test_flash_diffusion_never_falls_back_and_rejects_what_it_does_not_take(monkeypatch):
    """Kernel O's wrappers send a tensor off the CPU to the kernel (without a
    build they raise, the masked CudaSdpa and the Function too) and refuse
    what it does not take before building."""
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    mask = torch.empty(9, 9, device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="head_dim"):
        # 32 is taken, padded to 64; 40 is not a multiple of 16
        flash_diffusion.flash_diffusion_fwd(meta(1, 4, 9, 40), meta(1, 2, 9, 40), meta(1, 2, 9, 40), mask)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_diffusion.flash_diffusion_fwd(meta(1, 3, 9, 64), meta(1, 2, 9, 64), meta(1, 2, 9, 64), mask)
    with pytest.raises(ValueError, match="share one dtype"):
        flash_diffusion.flash_diffusion_fwd(meta(1, 4, 9, 64), meta(1, 2, 9, 64, dtype=torch.float16),
                                            meta(1, 2, 9, 64, dtype=torch.float16), mask)
    with pytest.raises(ValueError, match="bool keep-mask"):
        flash_diffusion.flash_diffusion_fwd(meta(1, 4, 9, 64), meta(1, 2, 9, 64), meta(1, 2, 9, 64),
                                            meta(9, 9, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_diffusion.flash_diffusion_fwd(meta(1, 9, 4, 64).transpose(1, 2), meta(1, 2, 9, 64),
                                            meta(1, 2, 9, 64), mask)
    with pytest.raises(ValueError, match="lse and delta"):
        flash_diffusion.flash_diffusion_dq(meta(1, 4, 9, 64), meta(1, 2, 9, 64), meta(1, 2, 9, 64),
                                           meta(1, 4, 9, 64), meta(1, 4, 9, 64), meta(1, 4, 9), mask)
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    q, kv = meta(1, 4, 9, 64), meta(1, 2, 9, 64)
    for call in (lambda: flash_diffusion.flash_diffusion_fwd(q, kv, kv, mask),
                 lambda: tm.MojoSdpa.get_backend_impl("cuda")(enable_gqa=True)(q, kv, kv, mask),
                 lambda: tm.MojoDiffusionAttentionFunction.get_backend_impl("cuda")()(q, kv, kv, mask, 0.1, True)):
        with pytest.raises(RuntimeError, match="no kernels built"):
            call()
    assert flash_diffusion.launches == flash_diffusion.launches_dq == flash_diffusion.launches_dkv == 0


def test_residual_add_and_conv_kernels_never_fall_back(monkeypatch):
    """Kernels P and Q: a tensor off the CPU goes to the kernel through the
    op, the Function and the wrappers; without a build they raise instead
    of running the plain version."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    f32 = torch.float32
    norm = tm.MojoResidualAddRMSNorm.get_backend_impl("cuda")(64, device="meta")
    conv = tm.MojoCausalConv1dFunction.get_backend_impl("cuda")()
    calls = [lambda: norm(meta(3, 64), meta(3, 64)),
             lambda: norms.residual_add_rmsnorm(meta(3, 64), meta(3, 64, dtype=f32), meta(64, dtype=f32), 1e-6),
             lambda: conv(meta(2, 9, 64), meta(64, 4, dtype=f32), None, None, meta(2, 64, 3), True, "silu"),
             lambda: conv1d_vjp.conv1d_fwd(meta(2, 9, 64), meta(64, 4, dtype=f32), None, meta(2, 3, 64), True),
             lambda: conv1d_vjp.conv1d_bwd(meta(2, 9, 64), meta(64, 4, dtype=f32), meta(64, dtype=f32),
                                           meta(2, 3, 64), meta(2, 9, 64), False)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no kernels built"):
            call()
    assert set(kernels.launch_counts().values()) == {0}


def test_residual_add_and_conv_wrappers_reject_what_the_kernels_do_not_take():
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    f32 = torch.float32
    w = meta(64, dtype=f32)
    with pytest.raises(ValueError, match="hidden's dtype or float32"):  # a mixed pair other than an fp32 residual
        norms.residual_add_rmsnorm(meta(3, 64), meta(3, 64, dtype=torch.float16), w, 1e-6)
    with pytest.raises(ValueError, match="hidden's dtype or float32"):
        norms.residual_add_rmsnorm(meta(3, 64, dtype=f32), meta(3, 64), w, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        norms.residual_add_rmsnorm(meta(64, 3).t(), meta(3, 64), w, 1e-6)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        norms.residual_add_rmsnorm(meta(3, 64, dtype=torch.float64), meta(3, 64, dtype=f32), w, 1e-6)
    x = meta(2, 9, 64)
    with pytest.raises(ValueError, match="W <= 16"):  # an over-large window
        conv1d_vjp.conv1d_fwd(x, meta(64, 17, dtype=f32), None, meta(2, 16, 64), True)
    with pytest.raises(ValueError, match="W <= 16"):
        conv1d_vjp.conv1d_bwd(x, meta(64, 17, dtype=f32), None, meta(2, 16, 64), x, True)
    with pytest.raises(ValueError, match="contiguous"):
        conv1d_vjp.conv1d_fwd(meta(2, 64, 9).transpose(1, 2), meta(64, 4, dtype=f32), None, meta(2, 3, 64), True)
    with pytest.raises(ValueError, match="bias must be float32"):
        conv1d_vjp.conv1d_fwd(x, meta(64, 4, dtype=f32), meta(64), meta(2, 3, 64), True)
    with pytest.raises(ValueError, match="W <= 16"):  # through the Function too
        tm.MojoCausalConv1dFunction.get_backend_impl("cuda")()(x, meta(64, 20, dtype=f32))
    assert norms.launches_residual_add == conv1d_vjp.launches == conv1d_vjp.launches_bwd == 0
