"""The plain reference: the D2Q9-BGK step of the upstream MPI code
(``ag14774/MPILattice-Boltzmann``, d2q9-bgk.c) in plain PyTorch.

It imports torch and numpy alone, never the program under test, and works
out everything from the deck, the drawn (omega, accel) and the obstacle
mask: the initial state, the forcing weights, the free-cell count and the
viscosity. One step, in the reference's order:

1. ``accelerate_flow``: on row ny-2, free cells whose populations 3, 6, 7
   stay positive gain w1 = density accel / 9 on 1 and lose it on 3, gain
   w2 = density accel / 36 on 5, 8 and lose it on 6, 7;
2. pull streaming on the periodic grid;
3. BGK collision towards the simplified equilibrium
   feq_k = w_k (rho + 3 c_k.m + (3 / (2 rho)) (3 (c_k.m)^2 - |m|^2)),
   bounce-back on obstacles;
4. the mean of |u| = |m| / rho over the free cells.

A batch of B independent solves (one (omega, accel) each, one mask) steps
together: ``f`` is (B, 9, ny, nx). ``dtype`` is the precision of every
tensor: float32 is the reference, bfloat16 the control. On a CUDA device
the steps replay as CUDA graphs of plain PyTorch operations.
"""

from __future__ import annotations

import numpy as np
import torch

CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
W0, W1, W2 = 4 / 9, 1 / 9, 1 / 36
W = (W0, W1, W1, W1, W1, W2, W2, W2, W2)
GRAPH_STEPS = 50


def f32(x: float) -> float:
    return float(np.float32(x))


class Reference:
    def __init__(self, mask: np.ndarray, density: float, reynolds_dim: int,
                 omegas, accels, dtype=torch.float32, device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mask = np.asarray(mask, dtype=bool)
        self.ny, self.nx = mask.shape
        self.batch = len(omegas)
        self.dtype, self.device = dtype, torch.device(device)
        self.density = f32(density)
        dev = self.device
        rho = np.float32(density)
        om = np.asarray(omegas, dtype=np.float32)
        acc = np.asarray(accels, dtype=np.float32)

        def per_solve(values):
            # a Python number where every solve shares it (the cheaper
            # kernels), else a (B, 1) column
            values = [float(v) for v in values]
            if len(set(values)) == 1:
                return values[0]
            return torch.tensor(values, dtype=dtype, device=dev)[:, None]

        self.omega = per_solve(om)
        self.w1 = per_solve(rho * acc / np.float32(9.0))
        self.w2 = per_solve(rho * acc / np.float32(36.0))
        self.free_inv = f32(np.float32(1.0) / np.float32(mask.size
                                                         - mask.sum()))
        nu = (np.float32(1.0) / np.float32(6.0)
              * (np.float32(2.0) / om - np.float32(1.0)))
        self.re_scale = [reynolds_dim / float(v) for v in nu]
        p, b = self.ny * self.nx, self.batch
        self.obst = torch.as_tensor(mask.reshape(p), device=dev)
        self.free_row = ~torch.as_tensor(mask[self.ny - 2], device=dev)
        # the state is held as (9, B, ny, nx): each population's plane of
        # every solve is contiguous
        ys, xs = np.divmod(np.arange(p), self.nx)
        idx = [(k * b + j) * p + ((ys - CY[k]) % self.ny) * self.nx
               + (xs - CX[k]) % self.nx for k in range(9) for j in range(b)]
        self.pull = torch.as_tensor(np.concatenate(idx).astype(np.int32),
                                    device=dev)

    def initial(self) -> torch.Tensor:
        """The state at rest, (B, 9, ny, nx): density w_k everywhere."""
        w = torch.tensor([f32(self.density * v) for v in W], dtype=self.dtype,
                         device=self.device)
        return w[None, :, None, None].expand(
            self.batch, 9, self.ny, self.nx).contiguous()

    def step(self, f: torch.Tensor, out: torch.Tensor):
        """One step of every solve from ``f`` into ``out``, both (9, B,
        ny, nx); returns the (B,) sums of |u|."""
        b, row = self.batch, self.ny - 2
        fr = f[:, :, row]
        ok = (self.free_row & (fr[3] - self.w1 > 0)
              & (fr[6] - self.w2 > 0) & (fr[7] - self.w2 > 0))
        d1 = ok * self.w1
        d2 = ok * self.w2
        fr[1] += d1
        fr[3] -= d1
        fr[5] += d2
        fr[6] -= d2
        fr[7] -= d2
        fr[8] += d2
        t = f.view(-1).index_select(0, self.pull).view(9, b, -1)
        new = out.view(9, b, -1)
        dens = t.sum(0)
        mx = (t[1] + t[5] + t[8]) - (t[3] + t[6] + t[7])
        my = (t[2] + t[5] + t[6]) - (t[4] + t[7] + t[8])
        inv = torch.reciprocal(dens)
        usq = torch.addcmul(mx * mx, my, my)
        h3 = inv * 4.5                              # 3 (3 / (2 rho))
        a = torch.addcmul(dens, inv, usq, value=-1.5)   # rho - 3|m|^2/(2rho)
        om = self.omega

        def relax(k, feq):
            relaxed = torch.lerp(t[k], feq, om)
            torch.where(self.obst, t[OPP[k]], relaxed, out=new[k])

        relax(0, a * W0)
        for k, mu in ((1, mx), (2, my), (5, mx + my), (6, my - mx)):
            c = torch.addcmul(a, h3 * mu, mu)       # a + 3 h (c_k.m)^2
            w = W1 if k < 5 else W2
            relax(k, torch.add(c, mu, alpha=3.0).mul_(w))
            relax(OPP[k], torch.add(c, mu, alpha=-3.0).mul_(w))
        speed = torch.where(self.obst, torch.zeros_like(inv),
                            torch.sqrt(usq) * inv)
        return speed.sum(1, dtype=self.dtype)

    def run(self, f: torch.Tensor, n_steps: int):
        """n_steps from ``f``, (B, 9, ny, nx); returns (f', (B, n_steps)
        float64 av series on the host)."""
        g = torch.empty((9, self.batch, self.ny, self.nx), dtype=self.dtype,
                        device=self.device)
        f = torch.empty_like(g).copy_(f.transpose(0, 1))
        out = []
        if self.device.type == "cuda":
            for size in (GRAPH_STEPS, n_steps % GRAPH_STEPS):
                count = n_steps // GRAPH_STEPS if size == GRAPH_STEPS else 1
                if size == 0 or count == 0:
                    continue
                graph, sums = self._graph(f, g, size)
                for _ in range(count):
                    graph.replay()
                    out.append(sums.clone())
        else:
            for _ in range(n_steps):
                out.append(self.step(f, g)[None])
                f, g = g, f
        av = torch.cat(out).T.double().cpu().numpy() * self.free_inv
        return f.transpose(0, 1).contiguous(), av

    def _graph(self, f: torch.Tensor, g: torch.Tensor, size: int):
        """A CUDA graph of ``size`` steps that advances ``f`` in place
        (``g`` its second buffer; ``size`` even, or the last graph) and
        writes the (size, B) sums it returns."""
        sums = torch.empty((size, self.batch), dtype=self.dtype,
                           device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step(f.clone(), g)         # warm the allocator
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            a, b = f, g
            for i in range(size):
                sums[i].copy_(self.step(a, b))
                a, b = b, a
            if a is not f:
                f.copy_(a)
        return graph, sums

    def fields(self, f: torch.Tensor) -> torch.Tensor:
        """The final_state planes of each solve's state ``f``: (B, 4, ny,
        nx) float64 u_x, u_y, |u|, pressure (obstacles: 0, 0, 0,
        density / 3; d2q9-bgk.c:1071-1112)."""
        f = f.double()
        mask = self.obst.view(self.ny, self.nx)
        dens = f.sum(1)
        mx = (f[:, 1] + f[:, 5] + f[:, 8]) - (f[:, 3] + f[:, 6] + f[:, 7])
        my = (f[:, 2] + f[:, 5] + f[:, 6]) - (f[:, 4] + f[:, 7] + f[:, 8])
        ux = torch.where(mask, 0.0, mx / dens)
        uy = torch.where(mask, 0.0, my / dens)
        u = torch.sqrt(ux * ux + uy * uy)
        p = torch.where(mask, self.density / 3.0, dens / 3.0)
        return torch.stack([ux, uy, u, p], 1)

    def reynolds(self, f: torch.Tensor) -> list:
        """Each solve's Reynolds number from its state ``f``: the mean |u|
        over free cells times reynolds_dim over the viscosity
        (d2q9-bgk.c:1002-1008)."""
        u = self.fields(f)[:, 2].sum((1, 2)) * self.free_inv
        return [float(a) * s for a, s in zip(u.cpu(), self.re_scale)]
