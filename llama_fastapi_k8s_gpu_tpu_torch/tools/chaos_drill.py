"""Chaos drill: kill, tear, slow, drain and reload a REAL replica fleet
mid-replay, and assert the KV-survivability invariants.

Boots two real replica processes behind an in-process prefix-affinity
router (serving/fleet/router.py), replays multi-turn conversations, then
injects one failure per scenario and checks the recovery story (the JAX
package's tools/chaos_drill.py, the RUNBOOK's "Surviving pod churn"):

``sigkill``
    SIGKILL the rendezvous owner mid-stream.  Invariants: the torn stream
    is the ONLY client-visible error; the survivor keeps answering 200 with
    its pull degrade attributed (the stamped prior owner is dead); the
    restarted owner pulls its conversations back
    (``kv_migration_pulls_total{reason="remap"}``) and its first batch
    beats the survivor's cold spill-over batch on token-weighted prefix
    reuse by >= 2x; ``pages_pinned == 0`` fleet-wide at the end.
``drain``
    SIGTERM the owner.  Invariants: shutdown completes within the grace
    budget; the successor shows migration pulls BEFORE the dying pod exits
    and its first post-drain turn reuses prompt tokens.
``torn-wire`` / ``slow-wire``
    Arm ``migrate_push:error`` / ``migrate_pull:slow`` (utils/faults.py,
    via ``LFKT_FAULTS``) on a replica, then force pulls with a drain.
    Invariants: every degrade is attributed in /health + /metrics, requests
    still answer 200, nothing hangs past its deadline.
``reload``
    Add, then remove, a model on the owner (``POST /admin/models/reload``)
    mid-replay.  Invariants: zero client-visible errors; the registry
    converges back.

Replicas: on the card each is ``python -m llama_fastapi_k8s_gpu_tpu_torch.server``;
with ``--device cpu`` each is ``python -m
llama_fastapi_k8s_gpu_tpu_torch.tools.cpu_replica`` (the same server, its
engine on the CPU).  Every port is ephemeral.  Without ``--model-dir`` the
drill writes the tiny model (tools/tinymodel.py).

Exit code 0 = every requested scenario held its invariants.  Usage::

    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill --device cpu     # all
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill --device cpu sigkill drain
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill \\
        --model-dir /models --model-name model.gguf torn-wire slow-wire reload

``--json`` adds one JSON line a scenario (its invariants and seconds);
``--log-dir`` keeps the replicas' logs (default: a temporary directory,
removed at the end; a failing boot prints its log's tail).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

PKG = __package__.rsplit(".", 1)[0]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# fleet plumbing
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _body(conv: int, history: list | None = None) -> bytes:
    return json.dumps({
        "bot_profile": {
            "name": f"Bot{conv}",
            "appearance": "tall, green eyes, red hair, calm voice",
            "system_prompt": f"You are concise assistant #{conv}.",
        },
        "user_profile": {"name": "Sam"},
        "context": history or [{"turn": "user", "message": "hello"}],
    }).encode()


def _opener(conv: int) -> list:
    return [{"turn": "user",
             "message": f"Hello bot {conv}! The quick brown fox jumps "
                        "over the lazy dog near the riverbank while "
                        "autumn leaves drift slowly down."}]


def _post(port: int, body: bytes, path: str = "/response",
          timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get_json(port: int, path: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _metric_sum(port: int, name: str, **labels) -> float:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    total = 0.0
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for ln in text.splitlines():
        head, _, val = ln.rpartition(" ")
        if (head == name or head.startswith(name + "{")) \
                and all(w in head for w in want):
            total += float(val)
    return total


class Fleet:
    """Two migrating replica processes and an in-process affinity router."""

    def __init__(self, model_dir: str, model_name: str, device: str | None,
                 log_dir: str, tag: str, boot_deadline: float = 420.0):
        self.model_dir = model_dir
        self.model_name = model_name
        self.device = device
        self.log_dir = log_dir
        self.tag = tag
        self.boot_deadline = boot_deadline
        self.ports = [_free_port(), _free_port()]
        self.router_port = _free_port()
        self.addrs = [f"127.0.0.1:{p}" for p in self.ports]
        self.fleet = ",".join(self.addrs)
        self.procs: dict[int, subprocess.Popen] = {}
        self.logs: dict[int, str] = {}
        self.table = None
        self.router = None
        self._router_stop = None
        self._router_thread = None

    def replica_env(self, port: int, **extra) -> dict:
        env = dict(os.environ)
        pypath = os.pathsep.join(filter(None, (ROOT, env.get("PYTHONPATH"))))
        env.update({
            "PYTHONPATH": pypath,
            "LFKT_MODEL_DIR": self.model_dir,
            "LFKT_MODEL_NAME": self.model_name,
            "LFKT_HOST": "127.0.0.1",
            "LFKT_PORT": str(port),
            "LFKT_JSON_LOGS": "0",
            "LFKT_MAX_CONTEXT_TOKENS": "512",
            "LFKT_PREFILL_BUCKETS": "64,128,256",
            "LFKT_MAX_GEN_TOKENS": "8",
            "LFKT_DECODE_CHUNK": "4",
            "LFKT_TEMPERATURE": "0.0",
            "LFKT_KV_PAGED": "1",
            "LFKT_KV_PAGE_TOKENS": "16",
            "LFKT_MIGRATE": "1",
            "LFKT_MIGRATE_BIND": "127.0.0.1",
            "LFKT_MIGRATE_PORT": "0",
            "LFKT_MIGRATE_SELF": f"127.0.0.1:{port}",
            "LFKT_FLEET_PEERS": self.fleet,
            "LFKT_MIGRATE_TOP_K": "1",
            "LFKT_MIGRATE_TIMEOUT_SECONDS": "10.0",
            "LFKT_MIGRATE_DRAIN_SECONDS": "5.0",
        })
        if self.device == "cpu":
            # two replicas share the host's cores with the drill
            env.setdefault("OMP_NUM_THREADS", "1")
        env.update({k: str(v) for k, v in extra.items()})
        return env

    def spawn(self, port: int, **extra) -> subprocess.Popen:
        entry = f"{PKG}.tools.cpu_replica" if self.device == "cpu" else f"{PKG}.server"
        log = os.path.join(self.log_dir, f"{self.tag}-{port}-{len(self.logs)}.log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", entry], env=self.replica_env(port, **extra),
                cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
        self.procs[port] = proc
        self.logs[port] = log
        return proc

    def tail(self, port: int, n: int = 3000) -> str:
        with open(self.logs[port], errors="replace") as fh:
            return fh.read()[-n:]

    def wait_ready(self, port: int) -> None:
        proc = self.procs[port]
        deadline = time.time() + self.boot_deadline
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    f"replica :{port} died during boot:\n{self.tail(port)}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health/ready",
                        timeout=5) as r:
                    if r.status == 200:
                        return
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.2)
        raise AssertionError(f"replica :{port} never became ready:\n{self.tail(port)}")

    def start(self, extra_by_port: dict | None = None) -> None:
        extra_by_port = extra_by_port or {}
        for port in self.ports:
            self.spawn(port, **extra_by_port.get(port, {}))
        for port in self.ports:
            self.wait_ready(port)
        self.start_router()

    def start_router(self) -> None:
        from ..serving.fleet.peers import PeerTable
        from ..serving.fleet.router import FleetRouter
        from ..utils.metrics import Metrics

        self.table = PeerTable(peers=self.addrs, probe_seconds=0.3,
                               backoff_seconds=0.3,
                               probe_timeout=2.0).start()
        self.router = FleetRouter(self.table, policy="affinity",
                                  metrics=Metrics(), fresh_seconds=600.0,
                                  proxy_timeout=30.0)
        ready = threading.Event()
        holder: dict = {}

        async def serve():
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            r = asyncio.Event()
            task = asyncio.create_task(self.router.serve(
                "127.0.0.1", self.router_port, ready_event=r,
                stop_event=holder["stop"]))
            await r.wait()
            ready.set()
            await task

        self._router_thread = threading.Thread(
            target=lambda: asyncio.run(serve()), daemon=True)
        self._router_thread.start()
        if not ready.wait(30):
            raise AssertionError("router never became ready")
        self._router_stop = lambda: holder["loop"].call_soon_threadsafe(
            holder["stop"].set)

    def owner_convs(self, victim: str, n: int = 3) -> list[int]:
        """n conversation ids whose rendezvous owner is ``victim`` —
        computed with the SAME opener the replay sends (the affinity key
        hashes bot name + system prompt + first context message)."""
        from ..serving.fleet.affinity import affinity_key, rendezvous_rank

        out = []
        for c in range(200, 400):
            key, _src = affinity_key(
                "/response", {}, _body(c, history=_opener(c)))
            if rendezvous_rank(key, self.addrs)[0] == victim:
                out.append(c)
                if len(out) == n:
                    return out
        raise AssertionError("rendezvous never chose the victim")

    def stop(self) -> None:
        if self._router_stop is not None:
            self._router_stop()
        if self._router_thread is not None:
            self._router_thread.join(10)
        if self.table is not None:
            self.table.stop()
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


class Checks:
    """The invariants one scenario held, in order; the first that fails
    raises."""

    def __init__(self):
        self.held: list[str] = []

    def __call__(self, ok: bool, what: str, why=None) -> None:
        if not ok:
            raise AssertionError(what if why is None else f"{what}: {why}")
        self.held.append(what)
        print(f"  [ok] {what}", flush=True)


def _turn(router_port: int, histories: dict, phase: str,
          failures: list | None = None) -> int:
    """One replay turn per conversation; returns client-visible errors
    (described in ``failures``)."""
    errors = 0
    for c, hist in histories.items():
        try:
            _status, raw = _post(router_port, _body(c, history=hist))
            reply = json.loads(raw)["response"]
        except (OSError, ValueError, KeyError) as e:   # counted: the invariant
            errors += 1
            reply = None
            if failures is not None:
                body = e.read()[:300] if isinstance(e, urllib.error.HTTPError) else b""
                failures.append(f"conversation {c}: {e!r} {body!r}")
        hist.append({"turn": "bot", "message": (reply or "...")[:400]})
        hist.append({"turn": "user",
                     "message": f"[{phase}] Please tell me more."})
    return errors


def _ratio(port: int, before: dict) -> tuple[float, dict]:
    now = {"reused": _metric_sum(port, "prefix_cache_reused_tokens_total"),
           "prompt": _metric_sum(port, "tokens_prompt_total")}
    d = {k: now[k] - before.get(k, 0.0) for k in now}
    return (d["reused"] / d["prompt"] if d["prompt"] else 0.0), now


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def scenario_sigkill(fleet: Fleet, check: Checks) -> None:
    fleet.start()
    victim_port, survivor_port = fleet.ports
    convs = fleet.owner_convs(fleet.addrs[0])
    histories = {c: _opener(c) for c in convs}
    failed: list = []
    check(_turn(fleet.router_port, histories, "warm", failed) == 0,
          "warm replay served with zero errors", failed)

    # SIGKILL the owner mid-stream
    req = urllib.request.Request(
        f"http://127.0.0.1:{fleet.router_port}/response/stream",
        data=_body(convs[0], history=histories[convs[0]]),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=60)
    resp.readline()
    fleet.procs[victim_port].send_signal(signal.SIGKILL)
    fleet.procs[victim_port].wait(timeout=30)
    t0 = time.time()
    try:
        while resp.readline():
            pass
    except OSError:      # a torn stream is the point
        pass
    check(time.time() - t0 < 30, "torn stream terminated bounded")
    resp.close()

    before = _ratio(survivor_port, {})[1]
    fails0 = _metric_sum(survivor_port, "kv_migration_failures_total")
    check(_turn(fleet.router_port, histories, "spill", failed) == 0,
          "spill-over replay served with zero errors", failed)
    cold, _ = _ratio(survivor_port, before)
    check(_metric_sum(survivor_port, "kv_migration_failures_total") > fails0,
          "survivor's pull against the dead owner is attributed")

    fleet.spawn(victim_port)
    fleet.wait_ready(victim_port)
    deadline = time.time() + 30
    while len(fleet.table.healthy()) < 2 and time.time() < deadline:
        time.sleep(0.3)
    check(len(fleet.table.healthy()) == 2, "owner re-admitted")
    before = _ratio(victim_port, {})[1]
    check(_turn(fleet.router_port, histories, "back", failed) == 0,
          "post-restart replay served with zero errors", failed)
    warm, _ = _ratio(victim_port, before)
    check(_metric_sum(victim_port, "kv_migration_pulls_total",
                      reason="remap") >= 1,
          "restarted owner pulled its conversations back (remap)")
    check(warm >= 2.0 * cold and warm > 0.3,
          f"warm restart ratio {warm:.3f} >= 2x cold control {cold:.3f}")
    for port in fleet.ports:
        check(_get_json(port, "/health")["engine"]["kv_pool"]
              ["pages_pinned"] == 0, f"pages_pinned == 0 on :{port}")


def scenario_drain(fleet: Fleet, check: Checks) -> None:
    fleet.start()
    victim_port, successor_port = fleet.ports
    convs = fleet.owner_convs(fleet.addrs[0])
    histories = {c: _opener(c) for c in convs}
    failed: list = []
    check(_turn(fleet.router_port, histories, "warm", failed) == 0,
          "warm replay served with zero errors", failed)

    pulls0 = _metric_sum(successor_port, "kv_migration_pulls_total")
    proc = fleet.procs[victim_port]
    t0 = time.time()
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=60)
    took = time.time() - t0
    check(took < 30, f"drain finished in {took:.1f}s (budget-bounded)")
    check(_metric_sum(successor_port, "kv_migration_pulls_total") > pulls0,
          "successor pulled pages during the drain window")
    before = _ratio(successor_port, {})[1]
    _turn(fleet.router_port, histories, "post-drain")
    warm, _ = _ratio(successor_port, before)
    check(warm > 0.0, f"successor's first post-drain turn warm ({warm:.3f})")
    check(_get_json(successor_port, "/health")["engine"]["kv_pool"]
          ["pages_pinned"] == 0, "pages_pinned == 0 on successor")


def scenario_torn_wire(fleet: Fleet, check: Checks) -> None:
    # the dying OWNER's page service tears every push mid-stream: the
    # drain-commanded successor pull sees a torn stream, degrades with
    # attribution, and never corrupts KV — shutdown stays on budget
    fleet.start({fleet.ports[0]: {"LFKT_FAULTS": "migrate_push:error"}})
    _run_wire_fault(fleet, check)


def scenario_slow_wire(fleet: Fleet, check: Checks) -> None:
    # the SUCCESSOR's pull hop stalls far past the migration timeout: the
    # dying pod's drain command times out (attributed on its side), the
    # successor's stalled pull fails its deadline — and a slow wire never
    # delays shutdown past the grace budget
    fleet.start({fleet.ports[1]: {
        "LFKT_FAULTS": "migrate_pull:slow:delay=10.0",
        "LFKT_MIGRATE_TIMEOUT_SECONDS": "2.0"}})
    _run_wire_fault(fleet, check)


def _run_wire_fault(fleet: Fleet, check: Checks) -> None:
    """SIGTERM the owner with a broken migration wire: the drain must
    degrade to normal termination (attributed on the successor), never
    hang shutdown, and the fleet keeps serving."""
    victim_port, survivor_port = fleet.ports
    convs = fleet.owner_convs(fleet.addrs[0])
    histories = {c: _opener(c) for c in convs}
    failed: list = []
    check(_turn(fleet.router_port, histories, "warm", failed) == 0,
          "warm replay served with zero errors", failed)
    proc = fleet.procs[victim_port]
    t0 = time.time()
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=60)
    took = time.time() - t0
    check(took < 30, f"broken wire did not delay shutdown ({took:.1f}s)")
    # the successor's degraded pulls attribute once their budget expires
    # (the slow hop sleeps out its stall first)
    deadline = time.time() + 30
    while time.time() < deadline and _metric_sum(
            survivor_port, "kv_migration_failures_total") == 0:
        time.sleep(0.5)
    check(_metric_sum(survivor_port, "kv_migration_failures_total") > 0,
          "wire degrade attributed in kv_migration_failures_total")
    doc = _get_json(survivor_port, "/health")["migration"]
    check(bool(doc["last_error"]),
          f"last_error attributed: {doc['last_error']!r:.80}")
    check(_turn(fleet.router_port, histories, "after", failed) == 0,
          "replay continues on the survivor despite the broken wire", failed)
    check(_get_json(survivor_port, "/health")["engine"]["kv_pool"]
          ["pages_pinned"] == 0, "pages_pinned == 0 on survivor")


def scenario_reload(fleet: Fleet, check: Checks) -> None:
    # live manifest reload mid-drill (POST /admin/models/reload): the owner
    # adds then removes an aux model WHILE serving the replay — the removal
    # drains the aux radix namespace; zero client-visible errors
    # throughout.  Migration refuses a registry by design, so this fleet
    # runs without it: the invariant is "reload never interrupts the
    # replay", not page migration
    path = os.path.join(fleet.model_dir, fleet.model_name)
    registry_env = {"LFKT_MIGRATE": "0", "LFKT_MODELS": f"main={path}"}
    fleet.start({p: dict(registry_env) for p in fleet.ports})
    owner_port = fleet.ports[0]
    convs = fleet.owner_convs(fleet.addrs[0])
    histories = {c: _opener(c) for c in convs}
    failed: list = []
    check(_turn(fleet.router_port, histories, "warm", failed) == 0,
          "warm replay served with zero errors", failed)

    done = threading.Event()
    errs: list = []

    def reload_twice():
        try:
            # add aux, then converge back (aux's namespace drains)
            _post(owner_port, json.dumps(
                {"models": f"main={path},aux={path}"}).encode(),
                path="/admin/models/reload")
            _post(owner_port, json.dumps(
                {"models": f"main={path}"}).encode(),
                path="/admin/models/reload")
        except (OSError, ValueError) as e:   # reported below
            errs.append(e)
        finally:
            done.set()

    threading.Thread(target=reload_twice, daemon=True).start()
    turns = 0
    deadline = time.time() + 600
    while not done.is_set() or turns < 2:
        # however many turns the reload takes (an 8B load on the card spans
        # dozens), each conversation keeps its opener and its last exchange,
        # so the prompts stay inside the context window
        for hist in histories.values():
            del hist[1:-2]
        check(_turn(fleet.router_port, histories, f"reload-{turns}", failed) == 0,
              f"replay turn {turns} clean during reload", failed)
        turns += 1
        if time.time() > deadline:
            raise AssertionError(f"reload never completed ({turns} turns)")
    check(not errs, f"both reloads succeeded ({errs})")
    models = [m["id"] for m in _get_json(owner_port, "/v1/models")["data"]]
    check(models == ["main"], f"registry converged back: {models}")


SCENARIOS = {
    "sigkill": scenario_sigkill,
    "drain": scenario_drain,
    "torn-wire": scenario_torn_wire,
    "slow-wire": scenario_slow_wire,
    "reload": scenario_reload,
}


def run(names: list[str], model_dir: str, model_name: str, device: str | None,
        log_dir: str, as_json: bool = False) -> int:
    failed = []
    for name in names:
        print(f"[drill] scenario: {name}", flush=True)
        t0 = time.time()
        check = Checks()
        fleet = Fleet(model_dir, model_name, device, log_dir, name)
        error = None
        try:
            SCENARIOS[name](fleet, check)
        except AssertionError as e:
            error = str(e)
        finally:
            fleet.stop()
        seconds = time.time() - t0
        if error is None:
            print(f"[drill] {name} PASS ({seconds:.1f}s)", flush=True)
        else:
            failed.append(name)
            print(f"[drill] {name} FAIL: {error}", flush=True)
        if as_json:
            print(json.dumps({"drill": name, "ok": error is None,
                              "seconds": round(seconds, 1),
                              "invariants": check.held, "error": error}), flush=True)
    if failed:
        print(f"[drill] FAILED scenarios: {', '.join(failed)}")
        return 1
    print("[drill] PASS: all scenarios held their invariants")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos_drill", description=__doc__.split("\n")[0])
    ap.add_argument("scenarios", nargs="*", default=[], choices=[*SCENARIOS, []],
                    help="subset to run (default: all)")
    ap.add_argument("--device", default=None,
                    help="cpu to serve the replicas' engines on the CPU "
                         "(default: the card)")
    ap.add_argument("--model-dir", default="",
                    help="directory holding --model-name (default: write "
                         "the tiny model to a temporary directory)")
    ap.add_argument("--model-name", default="tiny.gguf")
    ap.add_argument("--log-dir", default="",
                    help="keep the replicas' logs here")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line a scenario: invariants and seconds")
    args = ap.parse_args(argv)

    if args.device != "cpu":
        from ..utils.device import resolve_device

        resolve_device(args.device)        # the card, or no drill at all
    with tempfile.TemporaryDirectory(prefix="chaos-drill-") as tmp:
        model_dir = os.path.abspath(args.model_dir) if args.model_dir else tmp
        if not args.model_dir:
            from .tinymodel import write_tiny_llama_gguf

            write_tiny_llama_gguf(os.path.join(tmp, args.model_name))
        log_dir = args.log_dir or tmp
        os.makedirs(log_dir, exist_ok=True)
        return run(args.scenarios or list(SCENARIOS), model_dir, args.model_name,
                   args.device, log_dir, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
