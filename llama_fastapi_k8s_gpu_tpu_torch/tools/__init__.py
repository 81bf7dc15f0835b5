"""The port's operator tools, each run as
``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.<name>``.

They ship inside the package, so a GPU pod's image carries them:

- ``incident_report`` — list, summarize and ``--validate`` the flight
  recorder's incident bundles (obs/flightrec.py);
- ``fleet_trace``     — one request's spans across the router and its peers,
  stitched (obs/fleettrace.py) and rendered as one waterfall;
- ``lint_report``     — the lint's per-rule table and the baseline ratchet;
- ``ci_gate``         — every repo gate over the port, one exit code;
- ``fault_drill``     — READY → DEGRADED → READY through the watchdog on a
  real engine;
- ``chaos_drill``     — kill, tear, slow, drain and reload a fleet of two
  real replica processes behind a router.

The first four load no torch (an operator runs them beside a wedged
engine); the drills load a model on the card unless given ``--device cpu``.
This package imports nothing.
"""
