"""A model module for the CPU tests alone, which copy it into a test's
root as ``models/toy_concat.py`` beside a configuration that names it: a
small model with another number of lookups in each table and the concat
interaction, so that the harness is seen to take a model of another
layout from files alone. Its program is a plain function of its own, not
the port's: each table stored in the order of its profile counts, ids
translated through ``rank_of``, each bag a sum of rows, the bottom MLP's
output and the bags concatenated into the top MLP.

A pool's ids are (N, B, sum(lookups)) int32, table ``t``'s in its own
``lookups[t]`` columns.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from recbench import arith, reference, synth
from recbench.traffic import zipf_ids


def _mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    n_dense: int
    embed_dim: int
    vocabs: tuple
    lookups: tuple            # one bag length a table
    bot_mlp: tuple
    top_mlp: tuple
    table_scale: float
    hot_frac: float
    logit_err_limit: float

    @classmethod
    def from_conf(cls, name: str, c: dict) -> Model:
        if c["interaction"] != "concat":
            raise ValueError(f"interaction {c['interaction']!r}: this model "
                             f"concatenates")
        if len(c["lookups"]) != len(c["vocabs"]):
            raise ValueError("one bag length a table")
        return cls(name=name, n_dense=c["n_dense"], embed_dim=c["embed_dim"],
                   vocabs=tuple(c["vocabs"]), lookups=tuple(c["lookups"]),
                   bot_mlp=tuple(c["bot_mlp"]), top_mlp=tuple(c["top_mlp"]),
                   table_scale=float(c["table_scale"]),
                   hot_frac=float(c["hot_frac"]),
                   logit_err_limit=float(c["check"]["logit_err_limit"]))

    @property
    def top_in(self) -> int:
        return self.bot_mlp[-1] + self.embed_dim * len(self.vocabs)

    def port_config(self):
        return None

    def make_weights(self, seed: int, device) -> dict:
        return {"bot": synth.mlp_weights(seed, "bot", self.bot_mlp,
                                         torch.float32, device),
                "top": synth.mlp_weights(seed, "top",
                                         (self.top_in,) + self.top_mlp,
                                         torch.float32, device)}

    def make_pool(self, traffic: dict, seed: int, device):
        n, b = int(traffic["pool_entries"]), int(traffic["entry_samples"])
        n_prof = int(traffic["profile_samples"])
        alpha = float(traffic["ids"]["alpha"])
        gen = torch.Generator(device=device)
        gen.manual_seed(synth.derive(seed, "pool"))
        prof_gen = torch.Generator(device=device)
        prof_gen.manual_seed(synth.derive(seed, "profile"))
        dense = torch.randn((n, b, self.n_dense), generator=gen,
                            device=device)
        cols, counts = [], []
        for v, k in zip(self.vocabs, self.lookups, strict=True):
            ids, prof = zipf_ids(v, alpha, n * b * k, n_prof * k, gen,
                                 prof_gen)
            cols.append(ids.view(n, b, k).to(torch.int32))
            counts.append(torch.bincount(prof, minlength=v).cpu().numpy())
        return dense, torch.cat(cols, dim=2), counts

    def build_program(self, weights: dict, counts, seed: int, device):
        t0 = time.perf_counter()
        params = {"tables": [], "rank_of": [], "hot_sizes": [], **weights}
        for t, (v, c) in enumerate(zip(self.vocabs, counts, strict=True)):
            order = torch.as_tensor(c).argsort(descending=True,
                                               stable=True).to(device)
            rank_of = torch.empty(v, dtype=torch.int64, device=device)
            rank_of[order] = torch.arange(v, device=device)
            logical = synth.make_table(seed, t, v, self.embed_dim,
                                       self.table_scale, torch.float32,
                                       device)
            params["tables"].append(logical[order])
            params["rank_of"].append(rank_of)
            params["hot_sizes"].append(max(1, int(self.hot_frac * v)))
        return params, time.perf_counter() - t0

    def forward(self, cfg, params: dict):
        def step(dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
            x = _mlp(params["bot"], dense)
            bags = [table[rank_of[ids.long()]].sum(1) for table, rank_of, ids
                    in zip(params["tables"], params["rank_of"],
                           self.table_ids(indices), strict=True)]
            z = torch.cat([x, *bags], dim=1)
            return _mlp(params["top"], z)[:, 0]
        return step

    def reference_logits(self, weights: dict, seed: int, dense: torch.Tensor,
                         indices: torch.Tensor,
                         precision: str = "float32") -> torch.Tensor:
        block = reference.BLOCK
        with reference.products(precision):
            outs = []
            for s in range(0, dense.shape[0], block):
                x = reference.mlp(weights["bot"],
                                  dense[s:s + block].float(), precision)
                bags = []
                for t, ids in enumerate(self.table_ids(indices[s:s + block])):
                    uniq, inv = torch.unique(ids.long(), return_inverse=True)
                    rows = synth.table_rows(seed, t, uniq, self.embed_dim,
                                            self.table_scale, torch.float32)
                    bags.append(rows[inv].sum(1))
                outs.append(reference.mlp(weights["top"],
                                          torch.cat([x, *bags], dim=1),
                                          precision)[:, 0])
            return torch.cat(outs)

    def flops_per_sample(self) -> int:
        """2 a multiply-add of the MLPs, 1 a row element each bag adds."""
        f = 0
        for sizes in (self.bot_mlp, (self.top_in,) + self.top_mlp):
            f += sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:],
                                               strict=True))
        return f + sum(self.lookups) * self.embed_dim

    def table_ids(self, indices: torch.Tensor) -> list[torch.Tensor]:
        return list(torch.split(indices, self.lookups, dim=-1))

    def sls_work(self, indices: torch.Tensor) -> tuple[float, float]:
        tables = self.table_ids(indices)
        return (arith.sls_bytes(tables, self.embed_dim, 4),
                arith.sls_adds(tables, self.embed_dim))
