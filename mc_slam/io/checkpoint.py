"""Map checkpoint / resume.

The reference declares SaveMap/LoadMap "future work" (include/System.h:102-104);
here the whole MapState is a pytree of arrays, so persistence is one npz file.
Saves/restores the map tables, keyframe NavStates + preintegrations, and the
host-side bookkeeping needed to resume tracking (keyframe order, raw IMU
buffers, gravity, VI-init flag).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from mc_slam.imu.navstate import NavState
from mc_slam.imu.preintegration import PreintState
from mc_slam.slam_map.mapstate import MapState


def _flatten(prefix, tree, out):
    if isinstance(tree, (MapState, NavState, PreintState)) or hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_map(path, m: MapState, extra: dict | None = None):
    """Write the MapState (+ JSON-serializable extras) to an npz file."""
    out = {}
    _flatten("", m, out)
    out["__extra__"] = np.frombuffer(
        json.dumps(extra or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_map(path):
    """Returns (MapState, extra_dict)."""
    data = np.load(path)
    get = lambda k: jnp.asarray(data[k])

    ns = NavState(P=get("kf_ns.P"), V=get("kf_ns.V"), R=get("kf_ns.R"),
                  bg=get("kf_ns.bg"), ba=get("kf_ns.ba"),
                  dbg=get("kf_ns.dbg"), dba=get("kf_ns.dba"))
    pre = PreintState(**{f: get(f"kf_preint.{f}") for f in PreintState._fields})
    fields = {}
    for f in MapState._fields:
        if f == "kf_ns":
            fields[f] = ns
        elif f == "kf_preint":
            fields[f] = pre
        else:
            fields[f] = get(f)
    extra = json.loads(bytes(data["__extra__"]).decode()) if "__extra__" in data else {}
    return MapState(**fields), extra


def save_system(path, sys):
    """Checkpoint a SlamSystem (map + host bookkeeping) for resume."""
    if hasattr(sys, "flush"):
        sys.flush()      # complete the in-flight frame before serializing
    extra = {
        "frame_id": sys.frame_id,
        "n_kf": sys.n_kf,
        "last_kf_slot": sys.last_kf_slot,
        "last_kf_frame": sys.last_kf_frame,
        "kf_slots": sys.kf_slots,
        "vi_inited": sys.vi_inited,
        "gw": np.asarray(sys.gw).tolist(),
        "first_kf_time": sys.first_kf_time,
        "state": sys.state,
        "kf_imu_raw": {str(k): v.tolist() for k, v in sys.kf_imu_raw.items()},
        "bow_hists_nonzero": [int(s) for s in sys.kf_slots],
        # accepted-closure topology (ADVICE r4): essential-graph re-inclusion
        # and cull/evict protection must survive resume, or the next closure
        # can re-open healed seams
        "loop_edges": [[int(a), int(b)] for a, b in sys.loop_edges],
        "n_loops_closed": sys.n_loops_closed,
        "broken_chain_slots": [int(s) for s in sys.broken_chain_slots],
        "free_slots": list(sys.free_slots),
        "next_fresh_slot": sys.next_fresh_slot,
        "hist_ids": {str(k): int(v) for k, v in sys.loop.hist_ids.items()},
    }
    save_map(path, sys.m, extra)
    # BoW histograms saved alongside (dense rows for active slots only)
    np.savez_compressed(str(path) + ".bow.npz",
                        hists=np.asarray(sys.loop.hists),
                        vocab=np.asarray(sys.loop.vocab))


def load_system(path, sys):
    """Restore a SlamSystem in place (constructed with matching capacities)."""
    m, extra = load_map(path)
    assert m.K == sys.cfg.max_kf and m.P == sys.cfg.max_mp, \
        "checkpoint capacities do not match the system config"
    sys.m = m
    sys.frame_id = extra["frame_id"]
    sys.n_kf = extra["n_kf"]
    sys.last_kf_slot = extra["last_kf_slot"]
    sys.last_kf_frame = extra["last_kf_frame"]
    sys.kf_slots = list(extra["kf_slots"])
    sys.vi_inited = extra["vi_inited"]
    sys.gw = jnp.asarray(extra["gw"], jnp.float32)
    sys.first_kf_time = extra["first_kf_time"]
    sys.state = extra["state"]
    sys.kf_imu_raw = {int(k): np.asarray(v, np.float32)
                      for k, v in extra["kf_imu_raw"].items()}
    sys.loop_edges = [tuple(e) for e in extra.get("loop_edges", [])]
    sys.n_loops_closed = extra.get("n_loops_closed", 0)
    sys.broken_chain_slots = set(extra.get("broken_chain_slots", []))
    sys.free_slots = list(extra.get("free_slots", []))
    sys.next_fresh_slot = extra.get(
        "next_fresh_slot", (max(sys.kf_slots) + 1) if sys.kf_slots else 0)
    sys.loop.hist_ids = {int(k): int(v)
                         for k, v in extra.get("hist_ids", {}).items()}
    try:
        bow = np.load(str(path) + ".bow.npz")
        sys.loop.hists = jnp.asarray(bow["hists"])
        sys.loop.vocab = jnp.asarray(bow["vocab"])
    except FileNotFoundError:
        pass
    # reseat tracking at the newest keyframe
    sys.last_pose = (sys.m.kf_ns.P[sys.last_kf_slot],
                     sys.m.kf_ns.R[sys.last_kf_slot])
    sys.last_ns = jax.tree_util.tree_map(
        lambda a: a[sys.last_kf_slot], sys.m.kf_ns)
    sys.prior = None
    sys.velocity = (jnp.zeros(3), jnp.eye(3))
    # rebuild host mirrors of immutable per-KF scalars (one batched pull)
    kf_time = np.asarray(m.kf_time)
    kf_id = np.asarray(m.kf_id)
    sys.kf_time_host = {s: float(kf_time[s]) for s in sys.kf_slots}
    sys.kf_id_host = {s: int(kf_id[s]) for s in sys.kf_slots}
    sys._invalidate_frame_caches()
    return sys
