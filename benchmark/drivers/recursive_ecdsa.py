"""Driver of the recursive configurations: one outer proof lane verifies one
lane of an inner flat ECDSA proof in-circuit (the program's
``recursive_verifier.verifier_circuit``), and re-exports its public inputs.

Set-up proves the pool's inner proofs with the inner configuration's prover,
which is then released.  Window entry, as a user of the API:
``recursive_verifier_inputs`` and the outer circuit's ``value_table`` on a
producer thread, then the outer ``Prover.dispatch_vals`` and ``collect``."""

from __future__ import annotations

import time

from benchmark import judge, proofs, traffic
from benchmark.ref.circuit import Common


class Session:
    def __init__(self, cell, device: str):
        from plonky2_ecdsa_tpu_torch import api
        from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
        from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
        from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
        from plonky2_ecdsa_tpu_torch.prover.prover import Prover

        cfg, mix, seed = cell.config, cell.traffic, cell.seed
        inner_cfg = cell.load_config(cfg["inner_config"])
        self.lanes = int(mix["batch"])
        self.spans = {}
        curve = api.CURVES[inner_cfg["curve"]]
        self.inner = api.EcdsaProverSystem(
            curve, getattr(CircuitConfig, inner_cfg["circuit_config"])(), device=device)
        self.spans["inner_circuit_build_s"] = self.inner.build_seconds
        t0 = time.perf_counter()
        self.pool = traffic.statement_pool(inner_cfg["curve"], mix, seed)
        self.spans["statements_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.inner_proofs = [self.inner.prove([
            api.EcdsaStatement(msg=s.msg, r=s.r, s=s.s, pk=api.cn.Point(curve, *s.pk))
            for s in batch]) for batch in self.pool]
        self.inner.prover.release()
        self.spans["inner_proofs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.outer = rv.verifier_circuit(self.inner.data,
                                         getattr(CircuitConfig, cfg["circuit_config"])())
        self.spans["outer_circuit_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.prover = Prover(build_circuit_data(self.outer, device))
        self.spans["outer_fixed_commit_s"] = time.perf_counter() - t0
        self._inputs = rv.recursive_verifier_inputs
        self.curve = inner_cfg["curve"]
        self.common, self.inner_common = cfg["circuit"], inner_cfg["circuit"]

    def witness(self, k: int):
        """(outer value table, outer public inputs) of pool batch k."""
        vals = self.outer.value_table(self._inputs(self.inner.data, self.inner_proofs[k]), self.lanes)
        return vals, self.outer.public_input_values()

    def graph_stats(self) -> dict:
        return self.prover.graph_stats.get(("vals", self.lanes), {})

    def judge(self, done: list, g) -> tuple:
        correct, numbers, info = judge.flat(self.common, self.curve, self.pool, done, g)
        inner = list(enumerate(self.inner_proofs))
        rejected, checked, why = judge.reject_count(
            Common(self.inner_common), [(proofs.arrays(p), range(self.lanes)) for _k, p in inner])
        numbers.append(("inner_lanes_rejected", rejected + judge.unbound(self.pool, inner), 0))
        info.update(inner_lanes_checked=checked, inner_failed_checks=why)
        return correct and judge.verdict(numbers) and checked > 0, numbers, info

    def release(self):
        self.prover.release()
