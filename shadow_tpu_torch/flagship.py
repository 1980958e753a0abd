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
    island_mode: str = "vmap",
    exchange_slots: int = 0,
    placement: str = "block",
    device=None,
):
    """``device=None`` means the card; pass ``device="cpu"`` for the CPU.
    ``num_shards > 1`` builds the islands engine (``parallel/islands.py``)
    with the JAX flagship's X, max(64, Hl·msgload // S), unless
    ``exchange_slots`` sets it."""
    from shadow_tpu_torch.sim import build_simulation

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
    island_exp = {}
    if num_shards > 1:
        if exchange_slots <= 0:
            # one wave's emissions of a shard, spread over the S shards;
            # misses defer safely under the window-end clamp
            hl = num_hosts // num_shards
            exchange_slots = max(64, hl * msgload // num_shards)
        island_exp = {
            "num_shards": num_shards,
            "island_mode": island_mode,
            "exchange_slots": exchange_slots,
            "placement": placement,
        }
    return build_simulation(
        {
            "general": {"stop_time": stop_s, "seed": seed},
            "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
            "experimental": {
                "event_capacity": event_capacity,
                "events_per_host_per_window": K,
                **island_exp,
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
