"""ray_tpu.state — queryable cluster state (the state API).

Reference: ``python/ray/experimental/state/api.py`` (list/get/summarize
for tasks, actors, objects, nodes, placement groups) backed by
``GcsTaskManager``; here the node's STATE_QUERY RPC serves the same
records straight from the control plane.
"""

from .api import (  # noqa: F401
    build_health_report,
    cluster_stacks,
    collective_health,
    events_stats,
    flight_records,
    health_report,
    list_actors,
    list_cluster_events,
    list_events,
    list_jobs,
    list_lifecycle_events,
    list_metrics,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    list_workers,
    memory_summary,
    metrics_history,
    metrics_trends,
    profile,
    serve_health,
    serve_requests,
    summarize_actors,
    summarize_metrics,
    summarize_tasks,
    timeline,
)
