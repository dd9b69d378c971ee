"""cuda-tier compute+comm ops: the ring forms of ``MojoAllGatherGemm`` and
``MojoGemmReduceScatter``, whose transfers overlap the GEMMs.

Counterpart of the JAX package's ``backends/xla/operators/compute_with_comm.py``
(``XlaAllGatherGemm`` :21, ``XlaGemmReduceScatter`` :56): chunks pass around
the group's ring, rank ``r`` sending to ``r + 1`` and receiving from
``r - 1`` (``torch.distributed.batch_isend_irecv``; JAX's ``ppermute``),
and each step multiplies the chunk already in hand while the next one is in
flight. The sums come out in JAX's ring order. A gather or scatter dim other
than 0 and a group of one rank take the golden, exactly as JAX does (:32,
:66); ``group=None`` is the plain GEMM. Gloo carries no send or receive of
CUDA tensors, so a ring over gloo on the card raises: it does not fall back
to the golden. NCCL refuses two ranks on one card, so on a machine with one
card the ring's arithmetic is checked on the CPU (gloo) alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mojo_opset_tpu_torch.core.operators.compute_with_comm import MojoAllGatherGemm, MojoGemmReduceScatter, _gemm
from mojo_opset_tpu_torch.runtime import comm_context


def _ring(group, x: torch.Tensor):
    """(size, rank, send-to, receive-from global ranks) of ``group``'s ring; raises for CUDA tensors over gloo."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        raise RuntimeError("the ring compute+comm ops pass CUDA tensors point to point, which gloo cannot: shard "
                           "over NCCL groups on the card")
    n, r = comm_context.group_size(group), comm_context.group_rank(group)
    return n, r, dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)


def _pass(group, send: torch.Tensor, recv: torch.Tensor, to: int, frm: int) -> list:
    """Start sending ``send`` to ``to`` and receiving ``recv`` from ``frm``; returns the requests to wait on."""
    return dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group), dist.P2POp(dist.irecv, recv, frm, group)])


def _wait(requests) -> None:
    for request in requests:
        request.wait()


class CudaAllGatherGemm(MojoAllGatherGemm):
    """The ring all-gather GEMM (gather dim 0): at step ``s`` rank ``r``
    multiplies the chunk of rank ``r - s`` while it passes that chunk on and
    takes the next; the products land in rank order."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return _gemm(input, self.weight, self.bias, self.trans_weight)
        if comm_context.group_size(self.group) == 1 or self.gather_dim != 0:
            return MojoAllGatherGemm.forward(self, input)
        n, r, to, frm = _ring(self.group, input)
        chunk = input.contiguous()
        local = chunk.shape[0]
        out = None
        for step in range(n):
            requests = []
            if step + 1 < n:
                nxt = torch.empty_like(chunk)
                requests = _pass(self.group, chunk, nxt, to, frm)
            part = _gemm(chunk, self.weight, self.bias, self.trans_weight)
            if out is None:
                out = part.new_empty((n * local,) + tuple(part.shape[1:]))
            src = (r - step) % n
            out[src * local:(src + 1) * local] = part
            if requests:
                _wait(requests)
                chunk = nxt
        return out


class CudaGemmReduceScatter(MojoGemmReduceScatter):
    """The ring GEMM + reduce-scatter (scatter dim 0): the running sum of a
    block of rows travels the ring, and each rank adds its product for the
    block it is about to pass on, computed while the sum is in flight; after
    ``n - 1`` hops rank ``r`` holds the sum of block ``r``, its own product
    added last, then the bias."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return _gemm(input, self.weight, self.bias, self.trans_weight)
        if comm_context.group_size(self.group) == 1 or self.scatter_dim != 0:
            return MojoGemmReduceScatter.forward(self, input)
        n, r, to, frm = _ring(self.group, input)
        if input.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 of size {input.shape[0]} does not split over {n} ranks")
        rows = input.shape[0] // n

        def product(step):
            target = (r + n - 1 - step) % n  # the block that reaches its rank after the hops left
            return _gemm(input[target * rows:(target + 1) * rows], self.weight, None, self.trans_weight)

        acc = product(0).contiguous()
        for step in range(1, n):
            recv = torch.empty_like(acc)
            requests = _pass(self.group, acc, recv, to, frm)
            part = product(step)  # while the sum is in flight
            _wait(requests)
            acc = recv + part  # JAX's order: the sum received, then this rank's product
        if self.bias is not None:
            acc = acc + self.bias
        return acc
