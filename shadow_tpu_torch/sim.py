"""Top-level simulation builder: Config → runnable Simulation.

The PHOLD branch of the JAX package's ``sim.py:build_simulation``: load
the topology, attach and register the hosts, bake the paths, and build a
``Simulation`` whose window step runs on the device. Other app models and
the engine options the port does not have yet raise ``BuildError`` naming
their ``ROADMAP.md`` queue item.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from shadow_tpu_torch.core import simtime, units
from shadow_tpu_torch.core.config import Config, load_config
from shadow_tpu_torch.core.engine import Simulation
from shadow_tpu_torch.core.state import NetParams, resolve_device
from shadow_tpu_torch.net.apps import PholdApp
from shadow_tpu_torch.routing.dns import Dns
from shadow_tpu_torch.routing.topology import BakedPaths, Topology


class BuildError(ValueError):
    pass


def _refuse_unported(cfg: Config) -> None:
    x = cfg.experimental
    unported = [
        (x.num_shards > 1, "islands (num_shards > 1)", "A 9"),
        (x.pool_gears != 1, "pool gears (pool_gears != 1)", "A 6"),
        (x.flight_recorder > 0, "the flight recorder", "A 8"),
        (not x.obs_counters or not x.audit_digest,
         "running without the obs block and audit chain", "A 8"),
        (any(h.cpu_ns_per_event for h in cfg.hosts),
         "the CPU model (cpu_ns_per_event)", "A 4"),
    ]
    for bad, what, item in unported:
        if bad:
            raise BuildError(f"{what} is not ported to shadow_tpu_torch yet "
                             f"(ROADMAP.md queue {item})")


def build_simulation(source, device=None) -> Simulation:
    """Build from a Config, YAML path/string, or dict. ``device=None`` means
    the card and raises where there is none; pass ``device="cpu"`` to run
    on the CPU."""
    dev = resolve_device(device)
    cfg = source if isinstance(source, Config) else load_config(source)
    if not cfg.hosts:
        raise BuildError("no hosts configured")
    app_names = {h.app_model for h in cfg.hosts if h.app_model}
    if app_names != {"phold"}:
        raise BuildError(
            f"app models {sorted(app_names)}: shadow_tpu_torch runs only "
            f"phold so far (ROADMAP.md queue A 7 ports the network stack "
            f"apps, A 12 managed processes)"
        )
    _refuse_unported(cfg)

    topo = Topology.from_gml(cfg.graph_gml(), cfg.network.use_shortest_path)
    dns = Dns()
    for i, h in enumerate(cfg.hosts):
        topo.attach_host(
            i,
            ip_address_hint=h.ip_address_hint,
            city_code_hint=h.city_code_hint,
            country_code_hint=h.country_code_hint,
            network_node_id=h.network_node_id,
        )
        dns.register(i, h.name, h.ip_address_hint)
    baked: BakedPaths = topo.bake()
    latency_vv = np.asarray(baked.latency_vv)
    params = NetParams(
        latency_vv=torch.as_tensor(latency_vv, dtype=torch.int64,
                                   device=dev),
        reliability_vv=torch.as_tensor(np.asarray(baked.reliability_vv),
                                       dtype=torch.float32, device=dev),
        bootstrap_end=int(cfg.general.bootstrap_end_time),
        vertex_g=(
            torch.as_tensor(np.asarray(baked.host_vertex),
                            dtype=torch.int32, device=dev)
            if latency_vv.shape[0] > 1 else None
        ),
    )
    runahead = cfg.experimental.runahead or baked.min_latency_ns
    if runahead > baked.min_latency_ns:
        warnings.warn(
            f"runahead {runahead}ns exceeds min topology latency "
            f"{baked.min_latency_ns}ns: cross-host events inside a window "
            f"may be processed one window late (accuracy/speed tradeoff)",
            stacklevel=2,
        )

    H = len(cfg.hosts)
    phold_hosts = [h for h in cfg.hosts if h.app_model == "phold"]
    if len(phold_hosts) != H:
        raise BuildError(
            "phold app model currently requires every host to run it"
        )
    distinct = {tuple(sorted(h.app_options.items())) for h in phold_hosts}
    if len(distinct) > 1:
        raise BuildError(
            "phold app_options must be identical across all hosts "
            "(per-host options are not supported yet)"
        )
    opts = phold_hosts[0].app_options
    app = PholdApp(
        H,
        msgload=int(opts.get("msgload", 1)),
        size_bytes=int(opts.get("size", 64)),
        start_time=units.parse_time_ns(opts.get("start_time", 1)),
        runtime=units.parse_time_ns(opts.get("runtime", 5)),
        hot_frac=float(opts.get("hot_frac", 0.0)),
        hot_share=float(opts.get("hot_share", 0.0)),
        local_span=int(opts.get("local_span", 0)),
    )
    # the matrix path's draw-offset arithmetic (two draws per send) needs
    # every destination reachable
    if np.any(latency_vv == simtime.NEVER):
        raise BuildError(
            "phold over a topology with unreachable paths takes the "
            "micro-step loop path, which is not ported yet (ROADMAP.md "
            "queue A 4)"
        )
    ((bulk_kind, width),) = app.bulk_kinds().items()
    outbox = cfg.experimental.outbox_slots
    if width > outbox:
        # the JAX package refuses this shape when it builds its window step
        # (one emission per PHOLD event, a bulk batch of `width` events)
        raise BuildError(
            f"outbox_slots O={outbox} cannot absorb a full bulk batch "
            f"(kind {bulk_kind}: 1 emissions x G={width}); raise "
            f"outbox_slots or lower the bulk width"
        )
    sim = Simulation(
        num_hosts=H,
        params=params,
        host_vertex=baked.host_vertex,
        seed=cfg.general.seed,
        stop_time=cfg.general.stop_time,
        runahead=runahead,
        bulk_kind=bulk_kind,
        matrix_handler=app.handle_msg_matrix,
        event_capacity=cfg.experimental.event_capacity,
        K=cfg.experimental.events_per_host_per_window,
        subs={PholdApp.SUB: app.init_sub(dev)},
        initial_events=app.initial_events(),
        payload_words=PholdApp.PAYLOAD_WORDS,
        device=dev,
    )
    sim.config = cfg
    sim.topology = topo
    sim.dns = dns
    sim.baked = baked
    sim.app = app
    return sim
