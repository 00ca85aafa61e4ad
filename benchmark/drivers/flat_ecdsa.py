"""Driver of the flat ECDSA-verify configurations: the program's
``EcdsaProverSystem`` for the configuration's curve and circuit config, one
proof lane a statement.

Window entry, as a user of the API: ``witness_vals`` on a producer thread,
then ``Prover.dispatch_vals`` and ``Prover.collect``."""

from __future__ import annotations

import time

from benchmark import judge, traffic


class Session:
    def __init__(self, cell, device: str):
        from plonky2_ecdsa_tpu_torch import api
        from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig

        cfg, mix, seed = cell.config, cell.traffic, cell.seed
        self.lanes = int(mix["batch"])
        self.spans = {}
        curve = api.CURVES[cfg["curve"]]
        self.system = api.EcdsaProverSystem(curve, getattr(CircuitConfig, cfg["circuit_config"])(),
                                            device=device)
        self.spans["circuit_build_s"] = self.system.build_seconds
        t0 = time.perf_counter()
        self.pool = traffic.statement_pool(cfg["curve"], mix, seed)
        self.spans["statements_s"] = time.perf_counter() - t0
        self._stmts = [[api.EcdsaStatement(msg=s.msg, r=s.r, s=s.s, pk=api.cn.Point(curve, *s.pk))
                        for s in batch] for batch in self.pool]
        t0 = time.perf_counter()
        self.prover = self.system.prover                 # the fixed commit on the device
        self.spans["fixed_commit_s"] = time.perf_counter() - t0
        self.curve = cfg["curve"]
        self.common = cfg["circuit"]

    def witness(self, k: int):
        """(value table, public inputs) of pool batch k."""
        return self.system.witness_vals(self._stmts[k])

    def graph_stats(self) -> dict:
        return self.prover.graph_stats.get(("vals", self.lanes), {})

    def judge(self, done: list, g) -> tuple:
        """done: [(pool index, host proof)] of the window, in order."""
        return judge.flat(self.common, self.curve, self.pool, done, g)

    def release(self):
        self.prover.release()
