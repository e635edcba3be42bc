"""Self-monitoring: only the reserved-namespace write check so far (a copy
of ``m3_tpu/selfmon/guard.py``'s check); the collector waits for ROADMAP
§A10."""
