"""Fleet profile merge: many processes' folded stacks as one flamegraph.

Port of ``m3_tpu/profiling/merge.py``: ``merge_profiles`` merges folded
tables by stack, tagging each stack's counts per instance;
``collect_fleet_profile`` pulls every peer's profile (any object with
``.profile(seconds=)``) beside the local one. A dead peer is counted and
reported, never fatal. (The coordinator's route that serves it is ROADMAP
§A10.)
"""

from __future__ import annotations

from ..utils.instrument import DEFAULT as METRICS

_M_PEER_ERRORS = METRICS.counter(
    "profile_fleet_peer_errors_total",
    "peer profile pulls that failed during a fleet profile merge",
)


def merge_profiles(profiles: list) -> dict:
    """``profiles``: [(instance_id, profile_dict)] (the StackSampler
    profile shape). Returns the merged folded table — stacks merged by
    identical frame sequence, each carrying its per-instance counts."""
    folded: dict[str, int] = {}
    by_instance: dict[str, dict] = {}
    for instance, prof in profiles:
        for stack, count in (prof or {}).get("folded", {}).items():
            folded[stack] = folded.get(stack, 0) + int(count)
            per = by_instance.setdefault(stack, {})
            per[instance] = per.get(instance, 0) + int(count)
    return {"folded": folded, "byInstance": by_instance}


def collect_fleet_profile(
    local_instance: str, local_profile: dict, peers: dict, seconds: float
) -> dict:
    """Pull + merge: the coordinator's own profile plus every peer's
    ``profile`` op result. ``peers``: {instance_id: node} where node
    exposes ``profile(seconds=...)`` (RemoteNode or any stub). The
    response is the ``/debug/pprof/fleet`` JSON shape."""
    profiles = [(local_instance, local_profile)]
    errors: dict[str, str] = {}
    for pid, node in sorted(peers.items()):
        try:
            profiles.append((pid, node.profile(seconds=seconds)))
        except Exception as exc:
            # a down peer must not cost the rest of the fleet's profile
            errors[pid] = f"{type(exc).__name__}: {exc}"
            _M_PEER_ERRORS.inc()
    merged = merge_profiles(profiles)
    return {
        "seconds": seconds,
        "instances": [inst for inst, _ in profiles],
        "errors": errors,
        "samples": sum(merged["folded"].values()),
        "folded": merged["folded"],
        "byInstance": merged["byInstance"],
    }
