"""Device-side application models: PHOLD.

PHOLD (the reference's PDES canary, src/test/phold): each received
message is forwarded to a random peer over the simulated network; the
message population is hosts × msgload; senders stop once simulated time
passes ``runtime``. This is the JAX package's ``net/apps.py:PholdApp`` in
its uniform-destination form, on the engine's matrix path. The per-event
``handle_msg`` of the loop path and the hot-spot and local-span variants
are not ported yet (``ROADMAP.md``, queue A).
"""

from __future__ import annotations

import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.state import KIND_APP_MSG, NetParams, SimState


class PholdApp:
    SUB = "phold"
    # PHOLD events carry only a message size: two payload words, packed
    # into one int64 column
    PAYLOAD_WORDS = 2

    def __init__(
        self,
        num_hosts: int,
        msgload: int = 1,
        size_bytes: int = 64,
        start_time: int = simtime.NS_PER_SEC,
        runtime: int = 5 * simtime.NS_PER_SEC,
        hot_frac: float = 0.0,
        hot_share: float = 0.0,
        local_span: int = 0,
    ):
        if hot_frac or hot_share or local_span:
            raise NotImplementedError(
                "phold hot_frac/hot_share and local_span are not ported to "
                "shadow_tpu_torch yet (ROADMAP.md queue A: PHOLD variants)"
            )
        self.num_hosts = num_hosts
        self.msgload = msgload
        self.size_bytes = size_bytes
        self.start_time = start_time
        self.stop_sending = start_time + runtime

    def init_sub(self, device=None) -> dict:
        H = self.num_hosts
        return {
            "received": torch.zeros(H, dtype=torch.int64, device=device),
            "forwarded": torch.zeros(H, dtype=torch.int64, device=device),
        }

    def bulk_kinds(self) -> dict[int, int]:
        """PHOLD's message kind never emits a self event inside the window
        (forwards land at +latency >= the window end), so every window of
        it can take the engine's matrix path."""
        return {KIND_APP_MSG: min(2 * self.msgload, 16)}

    def initial_events(self):
        """msgload seed messages per host, self-delivered at start_time."""
        out = []
        for h in range(self.num_hosts):
            for _ in range(self.msgload):
                out.append(
                    (self.start_time, h, h, KIND_APP_MSG, [self.size_bytes])
                )
        return out

    def handle_msg_matrix(self, state: SimState, dense, params: NetParams,
                          win_end: int,
                          ops: kernels.WindowOps) -> kernels.ForwardOut:
        """Forward every message of the window's dense [H, K] matrix (the
        kernel ``phold_forward``). Updates the draw counters, the app
        sub-state and the packet counters; returns the numbered emission
        rows for the engine. Event k's draws sit at counters
        c0 + 2·(sends before k) and +1, which needs every destination
        reachable (``sim.py`` registers this handler only then)."""
        h = state.host
        fw = ops.phold_forward(
            dense.time, dense.payload, state.rng_keys, h.rng_counter,
            h.seq_next, h.gid, h.vertex, params.latency_vv,
            params.reliability_vv, params.vertex_g,
            num_hosts=self.num_hosts, stop_sending=self.stop_sending,
            bootstrap_end=params.bootstrap_end, win_end=win_end,
            kind=KIND_APP_MSG,
        )
        h.rng_counter = fw.rng_counter
        sub = state.subs[self.SUB]
        state.subs[self.SUB] = {
            "received": sub["received"] + fw.stats[:, 0],
            "forwarded": sub["forwarded"] + fw.stats[:, 1],
        }
        sent = fw.stats[:, 1].sum()
        c = state.counters
        c.packets_sent = c.packets_sent + sent
        c.packets_dropped_loss = (c.packets_dropped_loss + sent
                                  - fw.stats[:, 2].sum())
        c.bytes_sent = c.bytes_sent + self.size_bytes * sent
        return fw
