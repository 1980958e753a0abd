"""The flagship workload: PHOLD over a 50 ms self-loop link.

The reference's PDES canary (src/test/phold/phold.yaml: peers on a
single-vertex self-loop graph exchanging random-destination messages),
scaled to any host count, with the JAX package's defaults.
"""

from __future__ import annotations

SELF_LOOP_50MS_GML = """\
graph [
  node [ id 0 bandwidth_down "81920 Kibit" bandwidth_up "81920 Kibit" ]
  edge [ source 0 target 0 latency "50 ms" packet_loss 0.0 ]
]
"""


def build_phold_flagship(
    num_hosts: int,
    msgload: int = 2,
    stop_s: int = 10,
    runtime_s: int | None = None,
    event_capacity: int | None = None,
    K: int | None = None,
    seed: int = 42,
    num_shards: int = 1,
    device=None,
):
    """``device=None`` means the card; pass ``device="cpu"`` for the CPU.
    ``num_shards > 1`` (islands) is not ported yet and raises."""
    from shadow_tpu_torch.sim import build_simulation

    if num_shards != 1:
        raise NotImplementedError(
            "islands (num_shards > 1) are not ported to shadow_tpu_torch "
            "yet (ROADMAP.md queue A 9)"
        )
    if runtime_s is None:
        runtime_s = max(stop_s - 2, 1)
    if event_capacity is None:
        # the live population is num_hosts × msgload; 1.5× covers the
        # merge's leftovers plus one window's emissions
        event_capacity = max(3 * num_hosts * msgload // 2, 4096)
    if K is None:
        # per-host wave occupancy is ~Poisson(msgload); msgload + 16 keeps
        # a straggler host's extra window pass improbable
        K = msgload + 16
    return build_simulation(
        {
            "general": {"stop_time": stop_s, "seed": seed},
            "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
            "experimental": {
                "event_capacity": event_capacity,
                "events_per_host_per_window": K,
                "outbox_slots": K,
                "inbox_slots": 4,
            },
            "hosts": {
                "peer": {
                    "quantity": num_hosts,
                    "app_model": "phold",
                    "app_options": {"msgload": msgload, "runtime": runtime_s},
                }
            },
        },
        device=device,
    )
