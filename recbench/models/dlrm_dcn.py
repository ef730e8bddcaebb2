"""MLPerf's DLRM-DCNv2 (TorchRec's ``DLRM_DCN``; the cross network of
arXiv:2008.13535): what a configuration file with ``"model": "dlrm_dcn"``
states, and everything the harness asks of that model.

The bottom MLP's output and each table's multi-hot bag (one bag length a
table) are concatenated into x0, a low-rank cross network runs over it,
``x_{l+1} = x0 * (x_l @ v_l @ w_l + b_l) + x_l`` a layer from x_0 = x0,
and the top MLP scores its output. ``Model.from_conf`` refuses any
interaction but ``"dcn"``. A ``Model`` gives the port's ``DCNConfig``
(held against the module the file's ``port_module`` names under
``repro_torch.configs``), the MLP and cross weights and the pool made from
the seed, the port's set-up (each table's remap planned from its profile
counts, the table stored in rank order, the plans attached), the timed
forward, the plain reference of its logits, its FLOPs per sample, the
bytes and adds of one grouped SLS launch, each table's ids in the pool,
and the cross network's FLOPs and bytes a sample (``cross_work``, read by
``metrics/dcn_roofline.py``).

A pool's ids are (N, B, sum(lookups)) int32 logical ids, table t's in its
own ``lookups[t]`` columns, as the port's forward takes ragged bags.
Loading this module imports nothing of the program: the port's modules
are imported inside the calls that drive them, so that the reference and
the arithmetic run without them.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import torch

from recbench import arith, reference, synth
from recbench.harness import sync
from recbench.traffic import zipf_ids

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cross_weights(seed: int, width: int, rank: int, layers: int,
                  dtype: torch.dtype, device) -> list[dict]:
    """The cross layers as the port holds them (``x @ v @ w + b``; v
    (width, rank), w (rank, width)), drawn on ``device`` from a generator
    seeded from ``seed``: v and w normal with TorchRec's xavier-normal
    standard deviation sqrt(2 / (width + rank)); b normal with standard
    deviation 1/sqrt(width), as ``synth.mlp_weights`` draws a bias (TorchRec
    starts it at zero), so that every bias add shows in the logits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(synth.derive(seed, "cross"))
    std = math.sqrt(2.0 / (width + rank))
    out = []
    for _ in range(layers):
        v = torch.randn((width, rank), generator=gen, device=device,
                        dtype=dtype).mul_(std)
        w = torch.randn((rank, width), generator=gen, device=device,
                        dtype=dtype).mul_(std)
        b = torch.randn((width,), generator=gen, device=device,
                        dtype=dtype).mul_(1.0 / math.sqrt(width))
        out.append({"v": v, "w": w, "b": b})
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    """A DLRM-DCN configuration as its file states it. ``bot_mlp`` and
    ``top_mlp`` are layer widths with the input and the output; the cross
    network and the top MLP take ``top_in`` = (n_tables + 1) x embed_dim.
    Table t's logical rows are uniform in [-s_t, s_t), s_t = sqrt(3 /
    lookups[t]), so that every bag has unit variance."""

    name: str
    port_module: str | None   # repro_torch.configs.<module>.CONFIG to equal
    n_dense: int
    embed_dim: int
    vocabs: tuple
    lookups: tuple            # one bag length a table
    bot_mlp: tuple
    top_mlp: tuple
    dcn_layers: int
    dcn_rank: int
    table_dtype: torch.dtype
    mlp_dtype: torch.dtype
    logit_err_limit: float    # the check's limit (PERF.md says from what)

    @property
    def n_tables(self) -> int:
        return len(self.vocabs)

    @property
    def top_in(self) -> int:
        return (self.n_tables + 1) * self.embed_dim

    @property
    def table_scales(self) -> tuple:
        return tuple(math.sqrt(3.0 / n) for n in self.lookups)

    @classmethod
    def from_conf(cls, name: str, c: dict) -> Model:
        if c["interaction"] != "dcn":
            raise ValueError(f"interaction {c['interaction']!r}: this "
                             f"model computes the dcn interaction only")
        lookups = tuple(int(n) for n in c["lookups"])
        if len(lookups) != len(c["vocabs"]) or min(lookups) < 1:
            raise ValueError("need one bag length of at least 1 a table")
        if c["bot_mlp"][0] != c["n_dense"] or \
                c["bot_mlp"][-1] != c["embed_dim"]:
            raise ValueError("the bottom MLP maps n_dense to embed_dim")
        return cls(name=name, port_module=c.get("port_module"),
                   n_dense=c["n_dense"], embed_dim=c["embed_dim"],
                   vocabs=tuple(c["vocabs"]), lookups=lookups,
                   bot_mlp=tuple(c["bot_mlp"]), top_mlp=tuple(c["top_mlp"]),
                   dcn_layers=int(c["dcn_layers"]),
                   dcn_rank=int(c["dcn_rank"]),
                   table_dtype=DTYPES[c["table_dtype"]],
                   mlp_dtype=DTYPES[c["mlp_dtype"]],
                   logit_err_limit=float(c["check"]["logit_err_limit"]))

    def port_config(self):
        """The port's ``DCNConfig`` of this model; where the file names a
        ``port_module``, it must equal that module's ``CONFIG`` (but for
        the name)."""
        from repro_torch.models.dlrm import DCNConfig
        cfg = DCNConfig(name=self.name, n_tables=self.n_tables,
                        n_dense=self.n_dense, embed_dim=self.embed_dim,
                        n_rows=self.vocabs, lookups=self.lookups,
                        bot_mlp=self.bot_mlp[1:], top_mlp=self.top_mlp[:-1],
                        interaction="dcn", dcn_layers=self.dcn_layers,
                        dcn_rank=self.dcn_rank)
        if self.port_module is not None:
            mod = importlib.import_module(
                f"repro_torch.configs.{self.port_module}")
            want = dataclasses.replace(mod.CONFIG, name=self.name)
            if want != cfg:
                raise ValueError(f"{self.name}: the file's sizes differ from "
                                 f"repro_torch.configs.{self.port_module}: "
                                 f"{want} != {cfg}")
        return cfg

    def make_weights(self, seed: int, device) -> dict:
        """The MLPs' and the cross network's weights, made by the harness
        from the seed."""
        return {"bot": synth.mlp_weights(seed, "bot", self.bot_mlp,
                                         self.mlp_dtype, device),
                "cross": cross_weights(seed, self.top_in, self.dcn_rank,
                                       self.dcn_layers, self.mlp_dtype,
                                       device),
                "top": synth.mlp_weights(seed, "top",
                                         (self.top_in,) + self.top_mlp,
                                         self.mlp_dtype, device)}

    def make_pool(self, traffic: dict, seed: int, device):
        """The pool a cell's timed path cycles through, and the access
        counts that profile its tables.

        Returns ``dense`` (N, B, n_dense) float32 (standard normal),
        ``indices`` (N, B, sum(lookups)) int32 logical ids and ``counts``,
        one (V,) int64 numpy array per table. Table t's ids are drawn
        independently for each of its ``lookups[t]`` lookups, Zipf by
        popularity over its vocabulary (``traffic.zipf_ids``); its counts
        come from a separate sample of ``profile_samples`` samples of the
        same traffic, never from the pool.
        """
        n, b = int(traffic["pool_entries"]), int(traffic["entry_samples"])
        n_prof = int(traffic["profile_samples"])
        alpha = float(traffic["ids"]["alpha"])
        gen = torch.Generator(device=device)
        gen.manual_seed(synth.derive(seed, "pool"))
        prof_gen = torch.Generator(device=device)
        prof_gen.manual_seed(synth.derive(seed, "profile"))
        dense = torch.randn((n, b, self.n_dense), generator=gen,
                            device=device)
        indices = torch.empty((n, b, sum(self.lookups)), dtype=torch.int32,
                              device=device)
        counts = []
        for v, cols in zip(self.vocabs, self.table_ids(indices),
                           strict=True):
            k = cols.shape[-1]
            ids, prof = zipf_ids(v, alpha, n * b * k, n_prof * k, gen,
                                 prof_gen)
            cols.copy_(ids.view(n, b, k))
            counts.append(torch.bincount(prof, minlength=v).cpu().numpy())
            del ids, prof
        return dense, indices, counts

    def build_program(self, weights: dict, counts, seed: int, device):
        """The port's set-up path: each table's remap plan from its counts,
        the table stored in rank order (its logical copy dropped at once,
        so the peak is the tables plus one), the plans attached. Returns
        the params and the host seconds spent in the port's calls."""
        from repro_torch.embedding.layout import RemapSpec, remap_table
        from repro_torch.models import dlrm
        spent = 0.0
        specs, stored = [], []
        for t, (v, s) in enumerate(zip(self.vocabs, self.table_scales,
                                       strict=True)):
            logical = synth.make_table(seed, t, v, self.embed_dim, s,
                                       self.table_dtype, device)
            sync(device)
            t0 = time.perf_counter()
            spec = RemapSpec.from_counts(counts[t])
            stored.append(remap_table(logical, spec))
            sync(device)
            spent += time.perf_counter() - t0
            specs.append(spec)
            del logical
        t0 = time.perf_counter()
        params = dlrm.add_remap({"tables": stored, **weights},
                                [s.rank_of for s in specs],
                                [s.hot_size for s in specs])
        sync(device)
        return params, spent + time.perf_counter() - t0

    def forward(self, cfg, params: dict):
        """The timed call, ``(dense, indices) -> logits``: the port's
        ``models.dlrm.forward`` as it stands when this is called, on
        ``params`` and ``cfg``."""
        from repro_torch.models import dlrm
        fwd = dlrm.forward

        def step(dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
            return fwd(params, {"dense": dense, "indices": indices}, cfg)
        return step

    def bags(self, seed: int, indices: torch.Tensor) -> torch.Tensor:
        """The reference's bags: (B, sum(lookups)) logical ids -> (B,
        n_tables, D) float32, each bag's rows added in float32 in lookup
        order and rounded once to the tables' dtype (the kernel's sum, bit
        for bit), from the rows it touches alone (``synth.table_rows``)."""
        b = indices.shape[0]
        out = torch.empty((b, self.n_tables, self.embed_dim),
                          dtype=torch.float32, device=indices.device)
        for t, (ids, s) in enumerate(zip(self.table_ids(indices),
                                         self.table_scales, strict=True)):
            uniq, inv = torch.unique(ids.reshape(-1).to(torch.int64),
                                     return_inverse=True)
            rows = synth.table_rows(seed, t, uniq, self.embed_dim, s,
                                    self.table_dtype).float()
            rows = rows[inv].view(b, ids.shape[1], -1)
            acc = torch.zeros_like(rows[:, 0])
            for j in range(rows.shape[1]):
                acc = acc + rows[:, j]
            out[:, t] = acc.to(self.table_dtype).float()
        return out

    def reference_logits(self, weights: dict, seed: int, dense: torch.Tensor,
                         indices: torch.Tensor,
                         precision: str = "float32") -> torch.Tensor:
        """The plain reference's logits (B,) float32 of samples ``dense``
        (B, n_dense) and ``indices`` (B, sum(lookups)), on their device, in
        blocks of ``reference.BLOCK``: no remap, no ``rank_of``, no kernel.
        The bottom MLP; x0 = [bottom; bags] flattened; each cross layer
        x = x0 * ((x @ v) @ w + b) + x from x = x0; the top MLP; weights of
        a lower dtype widened to float32 first. ``precision`` as
        ``reference.products`` takes it; ``"tf32"`` rounds the cross
        products' operands too."""
        block = reference.BLOCK
        with reference.products(precision):
            outs = []
            for s in range(0, dense.shape[0], block):
                x = reference.mlp(weights["bot"],
                                  dense[s:s + block].float(), precision)
                z = torch.cat([x[:, None, :],
                               self.bags(seed, indices[s:s + block])], dim=1)
                x0 = z.reshape(z.shape[0], -1)
                x = x0
                for layer in weights["cross"]:
                    xw = reference._mm(
                        reference._mm(x, layer["v"].float(), precision),
                        layer["w"].float(), precision)
                    x = x0 * (xw + layer["b"].float()) + x
                outs.append(reference.mlp(weights["top"], x,
                                          precision)[:, 0])
            return torch.cat(outs)

    def cross_work(self) -> tuple[float, float]:
        """The interaction arch's FLOPs and bytes a sample, for its
        roofline: per cross layer 2 x top_in x rank multiply-adds in each
        of its two products (4 x top_in x rank FLOPs) and 3 x top_in for
        the bias add, the product with x0 and the residual add; bytes the
        least the span moves a sample in float32 activations: the bottom
        output and the bags read and x0 written, then per layer x_l and x0
        read, x_l @ v written and read, x_{l+1} written. The weights (read
        once a step) are left out."""
        w, r, d = self.top_in, self.dcn_rank, self.embed_dim
        esize = torch.empty((), dtype=self.table_dtype).element_size()
        flops = self.dcn_layers * (4 * w * r + 3 * w)
        n_bytes = d * 4 + self.n_tables * d * esize + w * 4 \
            + self.dcn_layers * (3 * w * 4 + 2 * r * 4)
        return float(flops), float(n_bytes)

    def flops_per_sample(self) -> int:
        """The forward FLOPs per sample: 2 x the MLPs' multiply-adds, the
        cross network's (``cross_work``) and 1 for each element of each row
        that an SLS bag adds.

        For dlrm-dcnv2: bottom 2 x 170,496, cross 3 x (4 x 3456 x 512 + 3
        x 3456) = 21,264,768, top 2 x 5,243,136, SLS 214 x 128 = 27,392:
        32,119,424 FLOPs."""
        f = 0
        for sizes in (self.bot_mlp, (self.top_in,) + self.top_mlp):
            f += sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:],
                                               strict=True))
        f += int(self.cross_work()[0])
        return f + sum(self.lookups) * self.embed_dim

    def table_ids(self, indices: torch.Tensor) -> list[torch.Tensor]:
        """Each table's ids in ``indices`` (..., sum(lookups)): one (...,
        lookups[t]) view a table."""
        return list(torch.split(indices, self.lookups, dim=-1))

    def sls_work(self, indices: torch.Tensor) -> tuple[float, float]:
        """The bytes and the adds of one grouped SLS launch over one pool
        entry's ``indices`` (B, sum(lookups)): ``arith.sls_bytes`` and
        ``arith.sls_adds`` of each table's ids, rows of ``embed_dim`` in
        the tables' dtype."""
        tables = self.table_ids(indices)
        esize = torch.empty((), dtype=self.table_dtype).element_size()
        return (arith.sls_bytes(tables, self.embed_dim, esize),
                arith.sls_adds(tables, self.embed_dim))
