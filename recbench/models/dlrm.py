"""The dot-interaction DLRM (Naumov et al., arXiv:1906.00091), with the
same number of lookups in every table: what a configuration file with
``"model": "dlrm"`` states, and everything the harness asks of that model.

``Model.from_conf`` reads the file and refuses any interaction but
``"dot"``. A ``Model`` gives the port's ``DLRMConfig`` (held against the
registry), the MLP weights and the pool made from the seed, the port's
set-up (each table's remap planned from its profile counts, the table
stored in rank order, the plans attached), the timed forward, the plain
reference of its logits, its FLOPs per sample, the bytes and adds of one
grouped SLS launch, and each table's ids in the pool.

A pool's ids are (N, B, n_tables, lookups) int32 logical ids. Loading this
module imports nothing of the program: the port's modules are imported
inside the calls that drive them, so that the reference and the
arithmetic run without them.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from recbench import arith, reference, synth
from recbench.harness import sync
from recbench.traffic import zipf_ids

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Model:
    """A DLRM configuration as its file states it. ``bot_mlp`` and
    ``top_mlp`` are layer widths with the input and the output; the top
    MLP's input width is derived from the interaction. ``id_rows`` is the
    file's ``source_vocabs`` where its stored ``vocabs`` are padded beyond
    them, else ``vocabs``."""

    name: str
    arch: str | None          # the port's registry name, checked against
    n_dense: int
    embed_dim: int
    vocabs: tuple
    lookups: int
    bot_mlp: tuple
    top_mlp: tuple
    table_dtype: torch.dtype
    mlp_dtype: torch.dtype
    table_scale: float        # logical rows are uniform in [-s, s)
    logit_err_limit: float    # the check's limit (PERF.md says from what)
    id_rows: tuple            # rows a table's ids are drawn over

    @property
    def n_tables(self) -> int:
        return len(self.vocabs)

    @property
    def top_in(self) -> int:
        n = self.n_tables + 1
        return self.embed_dim + n * (n - 1) // 2

    @classmethod
    def from_conf(cls, name: str, c: dict) -> Model:
        if c["interaction"] != "dot":
            raise ValueError(f"interaction {c['interaction']!r}: this "
                             f"model computes the dot interaction only")
        return cls(name=name, arch=c.get("arch"), n_dense=c["n_dense"],
                   embed_dim=c["embed_dim"], vocabs=tuple(c["vocabs"]),
                   lookups=c["lookups"], bot_mlp=tuple(c["bot_mlp"]),
                   top_mlp=tuple(c["top_mlp"]),
                   table_dtype=DTYPES[c["table_dtype"]],
                   mlp_dtype=DTYPES[c["mlp_dtype"]],
                   table_scale=float(c["table_scale"]),
                   logit_err_limit=float(c["check"]["logit_err_limit"]),
                   id_rows=tuple(c.get("source_vocabs", c["vocabs"])))

    def port_config(self):
        """The port's ``DLRMConfig`` of this model; where the file names a
        registry arch, its sizes and its tables' dtype must be the
        registry's (the MLPs keep the file's own, the source's, dtype)."""
        from repro_torch import configs
        from repro_torch.models.dlrm import DLRMConfig
        cfg = DLRMConfig(name=self.name, n_tables=self.n_tables,
                         n_dense=self.n_dense, embed_dim=self.embed_dim,
                         n_rows=self.vocabs, lookups=self.lookups,
                         bot_mlp=self.bot_mlp[1:], top_mlp=self.top_mlp[:-1])
        if self.arch is not None:
            bundle = configs.get_arch(self.arch)
            reg = dataclasses.replace(bundle.cfg, name=self.name)
            if reg != cfg:
                raise ValueError(f"{self.name}: the file's sizes differ from "
                                 f"the registry's {self.arch}: {reg} != "
                                 f"{cfg}")
            dtype = bundle.init.keywords["dtype"]
            if dtype != self.table_dtype:
                raise ValueError(f"{self.name}: the registry's {self.arch} "
                                 f"holds its tables in {dtype}")
        return cfg

    def make_weights(self, seed: int, device) -> dict:
        """The MLPs' weights, made by the harness from the seed."""
        return {"bot": synth.mlp_weights(seed, "bot", self.bot_mlp,
                                         self.mlp_dtype, device),
                "top": synth.mlp_weights(seed, "top",
                                         (self.top_in,) + self.top_mlp,
                                         self.mlp_dtype, device)}

    def make_pool(self, traffic: dict, seed: int, device):
        """The pool a cell's timed path cycles through, and the access
        counts that profile its tables.

        Returns ``dense`` (N, B, n_dense) float32 (standard normal),
        ``indices`` (N, B, n_tables, lookups) int32 logical ids and
        ``counts``, one (V,) int64 numpy array per table. The pool holds N
        entries of B samples (a bulk cell's batches; an online cell's
        requests, B = 1). The counts come from a separate sample of
        ``profile_samples`` samples of the same traffic (same popularity
        permutation, other draws), never from the pool. Table ``t``'s ids
        are drawn over its first ``id_rows[t]`` rows (the source's
        vocabulary, where the stored table is padded beyond it), so
        padding rows are never looked up.
        """
        n, b = int(traffic["pool_entries"]), int(traffic["entry_samples"])
        n_prof = int(traffic["profile_samples"])
        alpha = float(traffic["ids"]["alpha"])
        lookups = self.lookups
        gen = torch.Generator(device=device)
        gen.manual_seed(synth.derive(seed, "pool"))
        prof_gen = torch.Generator(device=device)
        prof_gen.manual_seed(synth.derive(seed, "profile"))
        dense = torch.randn((n, b, self.n_dense), generator=gen,
                            device=device)
        indices = torch.empty((n, b, self.n_tables, lookups),
                              dtype=torch.int32, device=device)
        counts = []
        for t, (v, rows) in enumerate(zip(self.vocabs, self.id_rows,
                                          strict=True)):
            ids, prof = zipf_ids(rows, alpha, n * b * lookups,
                                 n_prof * lookups, gen, prof_gen)
            indices[:, :, t, :] = ids.view(n, b, lookups).to(torch.int32)
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
        for t, v in enumerate(self.vocabs):
            logical = synth.make_table(seed, t, v, self.embed_dim,
                                       self.table_scale, self.table_dtype,
                                       device)
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
        """The reference's bags: (B, n_tables, L) logical ids -> (B,
        n_tables, D) float32, each bag added in float32 and rounded once to
        the tables' dtype, from the rows it touches alone
        (``synth.table_rows``)."""
        b, n_t, n_l = indices.shape
        out = torch.empty((b, n_t, self.embed_dim), dtype=torch.float32,
                          device=indices.device)
        for t in range(n_t):
            ids = indices[:, t, :].reshape(-1).to(torch.int64)
            uniq, inv = torch.unique(ids, return_inverse=True)
            rows = synth.table_rows(seed, t, uniq, self.embed_dim,
                                    self.table_scale,
                                    self.table_dtype).float()
            bag = rows[inv].view(b, n_l, -1).sum(1)
            out[:, t] = bag.to(self.table_dtype).float()
        return out

    def reference_logits(self, weights: dict, seed: int, dense: torch.Tensor,
                         indices: torch.Tensor,
                         precision: str = "float32") -> torch.Tensor:
        """The plain reference's logits (B,) float32 of samples ``dense``
        (B, n_dense) and ``indices`` (B, n_tables, L), on their device, in
        blocks of ``reference.BLOCK``: no remap, no ``rank_of``, no kernel.
        The bottom MLP, the dot interaction (the bottom output, then the
        strict upper triangle of the Gram of [bottom; bags] in row-major
        pair order) and the top MLP; weights of a lower dtype widened to
        float32 first. ``precision`` as ``reference.products`` takes it;
        ``"tf32"`` rounds the Gram's operands too."""
        block = reference.BLOCK
        with reference.products(precision):
            outs = []
            n = self.n_tables + 1
            iu, ju = torch.triu_indices(n, n, 1, device=dense.device)
            for s in range(0, dense.shape[0], block):
                x = reference.mlp(weights["bot"],
                                  dense[s:s + block].float(), precision)
                z = torch.cat([x[:, None, :],
                               self.bags(seed, indices[s:s + block])], dim=1)
                zt = z.transpose(1, 2)
                if precision == "tf32":
                    z, zt = reference.round_tf32(z), reference.round_tf32(zt)
                gram = torch.bmm(z, zt)
                feat = torch.cat([x, gram[:, iu, ju]], dim=1)
                outs.append(reference.mlp(weights["top"], feat,
                                          precision)[:, 0])
            return torch.cat(outs)

    def flops_per_sample(self) -> int:
        """The forward FLOPs per sample: 2 x the MLPs' multiply-adds; 2 x
        ``embed_dim`` for each of the n(n-1)/2 distinct pairs of the n =
        n_tables + 1 vectors that the dot interaction multiplies; 1 for
        each element of each row that an SLS bag adds.

        A frozen copy of ``repro_torch.models.dlrm.DLRMConfig.
        flops_per_sample``, counting only the work the model does (that
        one counts a bottom layer the model does not have, all (n_tables +
        1)^2 dots and 2 FLOPs an SLS add)."""
        n = self.n_tables + 1
        pairs = n * (n - 1) // 2
        bot = self.bot_mlp
        f = sum(2 * a * b for a, b in zip(bot[:-1], bot[1:], strict=True))
        top = (self.embed_dim + pairs,) + tuple(self.top_mlp)
        f += sum(2 * a * b for a, b in zip(top[:-1], top[1:], strict=True))
        f += 2 * pairs * self.embed_dim
        f += self.n_tables * self.lookups * self.embed_dim
        return f

    def table_ids(self, indices: torch.Tensor) -> list[torch.Tensor]:
        """Each table's ids in ``indices`` (..., n_tables, L): one (..., L)
        view a table."""
        return [indices[..., t, :] for t in range(self.n_tables)]

    def sls_work(self, indices: torch.Tensor) -> tuple[float, float]:
        """The bytes and the adds of one grouped SLS launch over one pool
        entry's ``indices`` (B, n_tables, L): ``arith.sls_bytes`` and
        ``arith.sls_adds`` of each table's ids, rows of ``embed_dim`` in
        the tables' dtype."""
        tables = self.table_ids(indices)
        esize = torch.empty((), dtype=self.table_dtype).element_size()
        return (arith.sls_bytes(tables, self.embed_dim, esize),
                arith.sls_adds(tables, self.embed_dim))
