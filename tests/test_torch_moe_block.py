"""Port parity for the toy ``MojoQwen3MoeBlock`` (embedding, qkv GEMM,
RMSNorm, dense causal GQA prefill, RMSNorm, gating, dispatch, one grouped
GEMM as the experts, combine) against the JAX package's block with the
same numpy weights, in both port tiers: ``ref`` (the goldens) and ``cuda``
(kernels A, J and H, here their plain versions on CPU tensors, which take
no golden route).

Tolerances: fp32 at atol = rtol = 1e-5 (fp32 sums in another order; the
router's top-2 picks the same experts); bf16 within the bf16 ladder
(``utils/acc.py``), the JAX block and the port rounding each op's output
to bf16 in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.qwen3 import MojoQwen3MoeBlock as JaxBlock
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.operators import CudaGroupGemm, CudaPrefillGQA, CudaRMSNorm
from mojo_opset_tpu_torch.modeling.qwen3 import MojoQwen3MoeBlock
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(vocab_size=64, hidden_size=32, num_heads=2, head_dim=16, num_experts=4, top_k=2)


@pytest.mark.parametrize("tier", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(tier, dtype, monkeypatch):
    monkeypatch.setenv("MOJO_BACKEND", tier)
    jblock = JaxBlock(**TINY, key=jax.random.PRNGKey(5), dtype=getattr(jnp, dtype))
    block = MojoQwen3MoeBlock(**TINY, device="cpu", dtype=getattr(torch, dtype),
                              generator=torch.Generator().manual_seed(5))
    load_numpy_state(block, state_dict_of(jblock))
    ids = np.random.default_rng(6).integers(0, 64, (2, 8)).astype(np.int32)
    want = jblock(jnp.asarray(ids))
    kinds = (block.pre_norm, block.attn, block.moe_gmm)
    assert all(isinstance(op, cls) for op, cls in zip(kinds, (CudaRMSNorm, CudaPrefillGQA, CudaGroupGemm))) == (
        tier == "cuda")
    goldens = [cls.golden_calls for cls in kernels.golden_classes()]
    kernels.reset_launch_counts()
    got = block(torch.from_numpy(ids))
    assert [cls.golden_calls for cls in kernels.golden_classes()] == goldens
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors run the plain versions
    assert got.shape == (2, 8, 32) and got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else tols_for(torch.bfloat16)
    check_tol_diff(got, np.asarray(want, np.float32), **tol)


def test_moe_block_weights_are_seeded():
    a, b = (MojoQwen3MoeBlock(**TINY, device="cpu", generator=torch.Generator().manual_seed(1)) for _ in range(2))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert a.pre_norm.weight.dtype == a.moe_gate.gate_weight.dtype == torch.float32
    assert a.moe_gmm.weight.dtype == a.qkv_proj.weight.dtype == torch.bfloat16
