"""Halo exchanges over the mesh's ``space`` axis (what GSPMD inserts for JAX's H sharding).

Each rank of a space group holds a band of every image's rows
(``Mesh.band``). An op that reads neighbouring rows (a 3x3 or 7x7 conv, the
stem's pool, a bilinear upsample) first takes the rows it needs from the
ranks above and below: ``SpaceAxis.exchange(x, top, bottom, zero_edges)``
returns x with ``top`` rows of the rank above and ``bottom`` rows of the
rank below. At the image's global edge there is no neighbour: with
``zero_edges`` the rows are zeros (a conv's zero padding, taken out of the
op, which then pads H by 0), without it nothing is added there (the
hand-written kernels' pad modes and the ceil-mode pool handle the edge as
the unsplit op does).

The exchange is an autograd Function: its backward sends the halo rows'
gradients back to their owners, which add them into their edge rows. One
collective each way, ``all_reduce`` over the space group of a buffer in
which each rank fills only its own slot (an all-gather made of the one
collective that both NCCL and gloo run on CUDA tensors: gloo's send, recv
and all_gather take CPU tensors only, and two ranks on one card talk over
gloo). Adding zeros is exact, so each rank reads its neighbours' rows bit
for bit.

``gather_rows`` all-gathers a per-rank ``(B, P)`` tensor along dim 1 over
the space group (the Lovasz hinge sorts whole images); its backward sums
the ranks' gradients of each slice into its owner.

``sum`` sums a per-rank tensor over the space group (a band's share of a
per-image value: multitask_unet's pooled features), and its backward sums
the ranks' gradients of the total, as ``mesh.global_sum`` does over the
whole job. What is computed from the total is each image's, held by every
rank of its group, so it is counted once: a loss of it by space index 0
only (the others count zero and still run the backward's collective).

``SpaceAxis.collectives`` counts the collectives, forward and backward.
Every collective goes through ``SpaceAxis.all_reduce``, so a test can run
the module's logic on shards in one process by giving it another.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from unet_embroidery_seg_torch.parallel.mesh import Mesh


class SpaceAxis:
    """This rank's place on the space axis: ``index`` of ``size`` bands, over ``group``."""

    collectives = 0  # all-reduces run over any space group, forward and backward

    def __init__(self, mesh: Mesh):
        if mesh.n_space < 2:
            raise ValueError("a space axis needs n_space >= 2")
        self.index, self.size, self.group = mesh.s, mesh.n_space, mesh.space_group

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def exchange(self, x: torch.Tensor, top: int, bottom: int,
                 zero_edges: bool = False) -> torch.Tensor:
        """NCHW ``x`` with ``top`` rows from the rank above and ``bottom`` from the rank below."""
        if top == 0 and bottom == 0:
            return x
        return _Exchange.apply(x, top, bottom, zero_edges, self)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(B, P) on each rank -> (B, size * P): the ranks' tensors side by side, in order."""
        return _GatherRows.apply(t, self)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the space group, with autograd (module docstring)."""
        return _SpaceSum.apply(t, self)

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the space group, in place: the one collective of this module."""
        dist.all_reduce(t, group=self.group)
        SpaceAxis.collectives += 1

    def all_slots(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``: one all-reduce of zeros but its own slot."""
        buf = t.new_zeros((self.size, *t.shape))
        buf[self.index].copy_(t)
        self.all_reduce(buf)
        return buf


def space_axis(mesh: Mesh | None) -> SpaceAxis | None:
    """The mesh's ``SpaceAxis``, or None where images are whole (no mesh, ``n_space`` 1)."""
    return None if mesh is None or mesh.n_space == 1 else SpaceAxis(mesh)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, zero_edges: bool, space: SpaceAxis):
        n, c, h, w = x.shape
        if h < max(top, bottom):
            raise ValueError(f"halo exchange: a band of {h} rows cannot give {max(top, bottom)}")
        # to the rank above: my first `bottom` rows (its bottom halo); to the
        # rank below: my last `top` rows (its top halo)
        slots = space.all_slots(torch.cat([x[:, :, :bottom], x[:, :, h - top:]], dim=2))
        above = top if (not space.first or zero_edges) else 0
        below = bottom if (not space.last or zero_edges) else 0
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        out = torch.empty((n, c, above + h + below, w), dtype=x.dtype, device=x.device,
                          memory_format=fmt)
        out[:, :, above:above + h].copy_(x)
        if space.first:
            out[:, :, :above].zero_()
        else:
            out[:, :, :top].copy_(slots[space.index - 1][:, :, bottom:])
        if space.last:
            out[:, :, above + h:].zero_()
        else:
            out[:, :, above + h:].copy_(slots[space.index + 1][:, :, :bottom])
        ctx.space, ctx.top, ctx.bottom, ctx.above, ctx.h = space, top, bottom, above, h
        return out

    @staticmethod
    def backward(ctx, g):
        space, top, bottom, above, h = ctx.space, ctx.top, ctx.bottom, ctx.above, ctx.h
        n, c, _, w = g.shape
        # my top halo's gradient goes to the rank above, my bottom halo's to the rank below
        send = g.new_zeros((n, c, top + bottom, w))
        if not space.first:
            send[:, :, :top].copy_(g[:, :, :top])
        if not space.last:
            send[:, :, top:].copy_(g[:, :, above + h:])
        slots = space.all_slots(send)
        dx = g[:, :, above:above + h].clone()
        if not space.first:  # the rank above's bottom halo: my first `bottom` rows
            dx[:, :, :bottom] += slots[space.index - 1][:, :, top:]
        if not space.last:  # the rank below's top halo: my last `top` rows
            dx[:, :, h - top:] += slots[space.index + 1][:, :, :top]
        return dx, None, None, None, None


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space: SpaceAxis):
        ctx.space = space
        total = t.clone(memory_format=torch.contiguous_format)
        space.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, g):
        total = g.clone(memory_format=torch.contiguous_format)
        ctx.space.all_reduce(total)
        return total, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space: SpaceAxis):
        ctx.space = space
        slots = space.all_slots(t.contiguous())  # (size, B, P)
        return slots.permute(1, 0, 2).reshape(t.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        space = ctx.space
        b = g.shape[0]
        # every rank's gradient of my slice, summed: one all-reduce of all slices
        total = g.reshape(b, space.size, -1).permute(1, 0, 2).contiguous()
        space.all_reduce(total)
        return total[space.index], None

