"""``sutro`` CLI.

The port of ``sutro_tpu/cli.py``, command for command, with the same
options, output text and exit codes: groups ``jobs``, ``datasets``,
``cache``, ``fleet``, ``replay`` and ``engine``; commands ``login``,
``docs``, ``set-base-url``, ``set-backend``, ``serve``, ``chat``,
``telemetry``, ``doctor``, ``trace``, ``watch`` and ``quotas``. Tables
render through tabulate (and pandas where a command reads a results
frame); auth is only enforced for the remote backend — the local
engine needs no key (``login`` still works and persists to
``~/.sutro/config.json``). ``engine info`` reports the CUDA devices
``torch`` sees.

This is the one module of the port that imports ``click`` and
``tabulate``; the engine, the server and the SDK run without them.
The local backend builds its engine on the card; to drive the CLI on
the CPU, build the engine first with
``engine.api.get_engine(ecfg, device="cpu")``.

Run as ``python -m sutro_tpu_torch.cli``.
"""

from __future__ import annotations

import datetime
import json
import sys
import time
from typing import Optional

import click
from tabulate import tabulate

from .common import to_colored_text
from .validation import load_config, save_config

BANNER = r"""
   ____  __  __ ______ ____   ____
  / ___/ / / / //_  __// __ \ / __ \
  \__ \ / /_/ /  / /  / /_/ // /_/ /
 ___/ / \__,_/  /_/  /_/ \_\ \____/   cuda
/____/
"""


def get_sdk():
    from .sdk import Sutro

    cfg = load_config()
    sdk = Sutro(api_key=cfg.get("api_key"))
    if cfg.get("base_url"):
        sdk.set_base_url(cfg["base_url"])
    if cfg.get("backend"):
        sdk.set_backend(cfg["backend"])
    return sdk


@click.group()
def cli() -> None:
    """Sutro — batch LLM inference on a CUDA card."""


@cli.command()
def login() -> None:
    """Store an API key (only needed for the remote backend)."""
    click.echo(to_colored_text(BANNER))
    key = click.prompt("API key", hide_input=True, default="", show_default=False)
    cfg = load_config()
    if key:
        cfg["api_key"] = key
        sdk = get_sdk()
        sdk.set_api_key(key)
        if sdk.backend == "remote":
            try:
                ok = sdk.try_authentication(key).get("authenticated", False)
            except Exception:
                ok = False
            if not ok:
                click.echo(to_colored_text("✗ Authentication failed", "fail"))
                sys.exit(1)
    save_config(cfg)
    click.echo(to_colored_text("✔ Logged in", "success"))


@cli.command()
def docs() -> None:
    """Open the documentation."""
    click.echo("https://docs.sutro.sh/")


@cli.command("set-base-url")
@click.argument("url")
def set_base_url(url: str) -> None:
    cfg = load_config()
    cfg["base_url"] = url
    save_config(cfg)
    click.echo(to_colored_text(f"✔ base_url set to {url}", "success"))


@cli.command("set-backend")
@click.argument("backend", type=click.Choice(["tpu", "remote", "fleet"]))
def set_backend(backend: str) -> None:
    cfg = load_config()
    cfg["backend"] = backend
    save_config(cfg)
    click.echo(to_colored_text(f"✔ backend set to {backend}", "success"))


@cli.command()
@click.option("--host", default="127.0.0.1", show_default=True)
@click.option("--port", default=8642, show_default=True)
@click.option("--quiet", is_flag=True, help="Suppress per-request logging")
@click.option("--interactive-slots", default=0, show_default=True, type=int,
              help="Reserved-slot budget for the interactive tier "
              "(/v1/chat/completions); 0 disables the endpoints")
def serve(host: str, port: int, quiet: bool, interactive_slots: int) -> None:
    """Run the engine as a long-lived HTTP daemon (detach/attach across
    processes; clients use `sutro set-backend remote` + `set-base-url`)."""
    from .server import serve as _serve

    ecfg = None
    if interactive_slots > 0:
        from .engine.config import load_engine_config

        ecfg = load_engine_config(interactive_slots=interactive_slots)
    _serve(host=host, port=port, ecfg=ecfg, verbose=not quiet)


# ---------------------------------------------------------------------------
# replica fleet (fleet/router.py)
# ---------------------------------------------------------------------------


@cli.group()
def fleet() -> None:
    """Replica fleet front door: route one API over N engine daemons."""


@fleet.command("serve")
@click.option("--host", default="127.0.0.1", show_default=True)
@click.option("--port", default=8640, show_default=True)
@click.option("--replica", "replicas", multiple=True, required=True,
              help="Engine daemon base URL (repeatable), e.g. "
              "--replica http://127.0.0.1:8642")
@click.option("--probe-interval", default=1.0, show_default=True,
              help="Seconds between health probes per replica")
@click.option("--quiet", is_flag=True, help="Suppress per-request logging")
def fleet_serve(host: str, port: int, replicas: tuple,
                probe_interval: float, quiet: bool) -> None:
    """Run the fleet router: health-checked, warm-prefix-affine routing
    over N `sutro serve` replicas sharing one SUTRO_HOME, with circuit
    breakers and jobstore-backed batch failover. Clients point
    `sutro set-backend fleet` + `set-base-url` at it."""
    from .fleet.router import serve_fleet

    serve_fleet(
        list(replicas), host=host, port=port,
        probe_interval=probe_interval, verbose=not quiet,
    )


@fleet.command("status")
@click.option("--json", "as_json", is_flag=True,
              help="Raw /fleet document instead of rendered output")
def fleet_status(as_json: bool) -> None:
    """Fleet membership + breaker states + failover counters + the
    fleet doctor verdict (requires base_url to point at a router)."""
    doc = get_sdk().get_fleet()
    if doc is None:
        click.echo(to_colored_text(
            "no fleet router at this base_url (single daemon?)", "fail"))
        sys.exit(1)
    if as_json:
        click.echo(json.dumps(doc, indent=2))
        return
    doctor_doc = doc.get("doctor") or {}
    click.echo(to_colored_text(
        f"fleet: {doc.get('n_healthy')}/{doc.get('n_replicas')} healthy"
        f" — verdict: {doctor_doc.get('verdict', '?')}", "callout"))
    for line in doctor_doc.get("evidence") or ():
        click.echo(f"  {line}")
    rows = [
        {
            "rid": r.get("rid"),
            "url": r.get("url"),
            "state": r.get("state"),
            "draining": r.get("draining"),
            "load": r.get("load"),
            "flaps": r.get("transitions_in_window"),
            "models": ",".join(r.get("models") or []),
        }
        for r in doc.get("replicas") or ()
    ]
    if rows:
        click.echo(tabulate(rows, headers="keys",
                            tablefmt="rounded_outline"))
    counters = doc.get("counters") or {}
    if counters:
        click.echo(to_colored_text(
            "counters: " + ", ".join(
                f"{k}={v}" for k, v in sorted(counters.items())), ))
    probe_only = doc.get("probe_only_routes")
    if probe_only is not None:
        click.echo(to_colored_text(
            f"probe-only routes (affinity probe disagreed with pick): "
            f"{probe_only}", ))
    lat = doc.get("route_latency")
    if lat:
        click.echo(to_colored_text(
            f"route latency: p50={lat.get('p50_s')}s "
            f"p99={lat.get('p99_s')}s over {lat.get('count')} route(s)", ))


@fleet.command("watch")
@click.option("--interval", default=2.0, show_default=True,
              help="Seconds between dashboard refreshes")
@click.option("--once", is_flag=True,
              help="Render one frame and exit (no screen clearing)")
@click.option("--json", "as_json", is_flag=True,
              help="Raw /fleet-monitor document instead of the dashboard")
def fleet_watch(interval: float, once: bool, as_json: bool) -> None:
    """Live fleet SLO dashboard over the router's fleet monitor
    (OBSERVABILITY.md "Fleet observability"): fleet-wide TTFT/route
    percentiles, failover and routed-prefix-hit rates, replica balance,
    active alerts with exemplar trace ids, and the fleet doctor
    verdict. Requires base_url to point at a ``sutro fleet`` router
    with telemetry + monitor enabled."""
    sdk = get_sdk()
    while True:
        try:
            doc = sdk.get_fleet_monitor()
        except KeyError as e:
            click.echo(to_colored_text(f"✗ {e}", "fail"))
            raise SystemExit(1)
        except Exception as e:  # noqa: BLE001 — remote 404/conn errors
            click.echo(to_colored_text(
                f"✗ fleet monitor unavailable: {e}", "fail"))
            raise SystemExit(1)
        if doc is None:
            click.echo(to_colored_text(
                "no fleet router at this base_url (single daemon?)",
                "fail"))
            raise SystemExit(1)
        if as_json:
            click.echo(json.dumps(doc, indent=2))
        else:
            if not once:
                click.clear()
            _render_fleet_watch_frame(doc)
        if once or as_json:
            return
        try:
            time.sleep(max(interval, 0.1))
        except KeyboardInterrupt:
            return


def _render_fleet_watch_frame(doc: dict) -> None:
    stats = doc.get("stats") or {}
    rates = stats.get("rates") or {}
    gauges = stats.get("gauges") or {}
    pcts = stats.get("percentiles") or {}
    click.echo(to_colored_text(
        f"sutro fleet watch — tick {doc.get('ticks')} · window "
        f"{stats.get('window_s', 0)}s · interval {doc.get('interval_s')}s"
        + (" · DEGRADED: " + str(doc["degraded"])
           if doc.get("degraded") else ""),
        "callout",
    ))
    row = {
        "healthy": "%d/%d" % (
            int(gauges.get("n_healthy", 0)),
            int(gauges.get("n_replicas", 0)),
        ),
        "draining": int(gauges.get("n_draining", 0)),
        "routed/s": rates.get("routed_per_s", 0.0),
        "failover/s": rates.get("failovers_per_s", 0.0),
    }
    hit = rates.get("routed_prefix_hit_rate")
    if hit is not None:
        row["prefix hit"] = f"{hit:.0%}"
    imbalance = gauges.get("replica_imbalance")
    if imbalance is not None:
        row["imbalance"] = f"{imbalance:.3g}x"
    ttft, route = pcts.get("fleet_ttft"), pcts.get("fleet_route")
    if ttft:
        row["ttft p50/p99 (s)"] = (
            f"{ttft['p50_s']:.3g}/{ttft.get('p99_s') or 0:.3g}"
        )
    if route:
        row["route p99 (s)"] = f"{route.get('p99_s') or 0:.3g}"
    click.echo(tabulate([row], headers="keys",
                        tablefmt="rounded_outline"))
    alerts = doc.get("alerts") or {}
    active = alerts.get("active") or []
    if active:
        click.echo(to_colored_text(
            f"⚠ {len(active)} alert(s) FIRING", "fail"))
        for a in active:
            click.echo(
                f"  {a['name']} [{a['severity']}] {a['metric']} "
                f"{a['op']} {a['threshold']} (value={a.get('value')})"
            )
    else:
        click.echo(to_colored_text("no alerts firing", "success"))
    events = (alerts.get("events") or [])[-5:]
    if events:
        click.echo("recent transitions:")
        for ev in events:
            line = (
                f"  {ev['state']:>8}  {ev['rule']} "
                f"(value={ev.get('value')})"
            )
            exemplars = ev.get("exemplar_trace_ids") or []
            if exemplars:
                line += " traces: " + ",".join(exemplars)
            click.echo(line)
    fleet_verdict = (doc.get("verdicts") or {}).get("fleet")
    if fleet_verdict:
        click.echo(to_colored_text(
            f"fleet doctor: {fleet_verdict.get('verdict')}", "callout"))
        for line in fleet_verdict.get("evidence") or ():
            click.echo(f"  {line}")


@cli.group()
def replay() -> None:
    """Trace-replay load harness: capture live traffic, replay it."""


@replay.command("record")
@click.option("-o", "--output", "output", required=True,
              type=click.Path(dir_okay=False),
              help="JSONL file to write replay records to")
def replay_record(output: str) -> None:
    """Drain the fleet router's trace ring into a replayable JSONL
    workload (arrival offsets, session ids, request bodies — see
    OBSERVABILITY.md "Fleet observability" for the record schema).
    Requires base_url to point at a ``sutro fleet`` router."""
    from .fleet import replay as replay_mod

    records = get_sdk().get_replay_log()
    if records is None:
        click.echo(to_colored_text(
            "no fleet router at this base_url (single daemon?)", "fail"))
        sys.exit(1)
    replay_mod.dump_jsonl(records, output)
    n_bodies = len([r for r in records if r.get("body")])
    click.echo(to_colored_text(
        f"✔ wrote {len(records)} record(s) ({n_bodies} with replayable "
        f"bodies) to {output}", "success"))


@replay.command("run")
@click.argument("workload", type=click.Path(exists=True, dir_okay=False))
@click.option("--speedup", default=1.0, show_default=True,
              help="Replay the arrival process this many times faster")
@click.option("--timeout", default=300.0, show_default=True,
              help="Per-request timeout (s)")
def replay_run(workload: str, speedup: float, timeout: float) -> None:
    """Replay a recorded JSONL workload against the current base_url,
    honoring the captured arrival process (open-loop), and report
    TTFT percentiles + error counts."""
    from .fleet import replay as replay_mod

    records = replay_mod.load_jsonl(workload)
    if not records:
        click.echo(to_colored_text("empty workload", "fail"))
        sys.exit(1)
    base = get_sdk().base_url.rstrip("/")
    click.echo(to_colored_text(
        f"replaying {len(records)} record(s) at {speedup}x against "
        f"{base} ...", "callout"))
    doc = replay_mod.replay(
        base, records, speedup=speedup, timeout=timeout)
    click.echo(json.dumps(doc, indent=2))


@cli.command()
@click.argument("prompt")
@click.option("--model", default="qwen-3-4b", show_default=True)
@click.option("--system", "system_prompt", default=None,
              help="System prompt")
@click.option("--no-stream", is_flag=True,
              help="Print the full response at once instead of streaming")
@click.option("--schema", "schema_file", default=None,
              type=click.Path(exists=True),
              help="JSON schema file; constrains the output "
              "(OpenAI response_format=json_schema)")
@click.option("--interactive-slots", default=None, type=int,
              help="Local backend only: enable the interactive tier "
              "with this reserved-slot budget")
@click.option("--session", "session_id", default=None,
              help="Sticky conversation id: turns reusing the same id "
              "keep their server-side transcript and tiered KV, so "
              "each call sends only the new user message")
def chat(prompt: str, model: str, system_prompt: Optional[str],
         no_stream: bool, schema_file: Optional[str],
         interactive_slots: Optional[int],
         session_id: Optional[str]) -> None:
    """One interactive chat completion (tokens stream to stdout)."""
    sdk = get_sdk()
    if interactive_slots is not None and sdk.backend != "remote":
        sdk._engine_config["interactive_slots"] = interactive_slots
    response_format = None
    if schema_file:
        with open(schema_file) as f:
            response_format = {
                "type": "json_schema",
                "json_schema": {"schema": json.load(f)},
            }
    try:
        if no_stream:
            resp = sdk.chat(
                prompt, model=model, system_prompt=system_prompt,
                response_format=response_format, session_id=session_id,
            )
            click.echo(resp["choices"][0]["message"]["content"])
            return
        for chunk in sdk.chat(
            prompt, model=model, system_prompt=system_prompt,
            response_format=response_format, stream=True,
            session_id=session_id,
        ):
            content = chunk["choices"][0]["delta"].get("content")
            if content:
                click.echo(content, nl=False)
        click.echo()
    except RuntimeError as e:
        click.echo(to_colored_text(f"✗ {e}", "fail"))
        sys.exit(1)


@cli.command()
@click.option("--job", "job_id", default=None,
              help="Per-job span timeline + counters instead of the "
              "process-wide metrics snapshot")
@click.option("--json", "as_json", is_flag=True,
              help="Raw JSON instead of rendered output")
def telemetry(job_id: Optional[str], as_json: bool) -> None:
    """Engine telemetry: live metrics snapshot, or one job's flight-
    recorder timeline with --job (OBSERVABILITY.md)."""
    sdk = get_sdk()
    if job_id is None:
        if as_json:
            from .telemetry import REGISTRY

            if sdk.backend == "remote":
                # remote registry is only exposed as prometheus text;
                # render that verbatim
                click.echo(sdk.get_metrics_text())
            else:
                click.echo(json.dumps(REGISTRY.to_json(), indent=2))
        else:
            click.echo(sdk.get_metrics_text(), nl=False)
        return
    doc = sdk.get_job_telemetry(job_id)
    if as_json:
        click.echo(json.dumps(doc, indent=2))
        return
    click.echo(to_colored_text(f"job {doc.get('job_id')}", "callout"))
    counters = doc.get("counters") or {}
    if counters:
        click.echo("counters:")
        for k, v in sorted(counters.items()):
            click.echo(f"  {k} = {v}")
    spans = doc.get("spans") or []
    click.echo(f"timeline ({len(spans)} span(s)):")
    rows = [
        {
            "t0_ms": round(1e3 * s["t0_s"], 1),
            "dur_ms": round(1e3 * s["dur_s"], 3),
            "stage": s["name"],
            "attrs": json.dumps(s.get("attrs") or {})[:48],
        }
        for s in spans[-60:]
    ]
    if rows:
        click.echo(
            tabulate(rows, headers="keys", tablefmt="rounded_outline")
        )
    if len(spans) > 60:
        click.echo(
            to_colored_text(f"(+ {len(spans) - 60} earlier)", "callout")
        )


@cli.command()
@click.argument("job_id")
@click.option("--json", "as_json", is_flag=True,
              help="Raw diagnosis document instead of rendered output")
def doctor(job_id: str, as_json: bool) -> None:
    """Bottleneck doctor: analyze a job's merged cross-process
    telemetry — per-worker stage attribution, roofline grades, and one
    named verdict (OBSERVABILITY.md "Doctor")."""
    diag = get_sdk().diagnose_job(job_id)
    if as_json:
        click.echo(json.dumps(diag, indent=2))
        return
    click.echo(to_colored_text(f"job {diag.get('job_id')}", "callout"))
    partial = (
        " (in flight — partial data)"
        if diag.get("in_flight")
        else " (partial data)"
        if diag.get("partial")
        else ""
    )
    click.echo(f"verdict: {diag.get('verdict')}{partial}")
    for line in diag.get("evidence") or []:
        click.echo(f"  - {line}")
    rows = []
    for name, p in sorted((diag.get("processes") or {}).items()):
        stages = p.get("stages") or {}
        top = max(
            stages, key=lambda k: stages[k]["total_s"], default=""
        )
        rl = p.get("roofline") or {}
        rows.append(
            {
                "process": name,
                "spans": p.get("spans"),
                "wall_s": p.get("wall_s"),
                "device_s": p.get("device_s"),
                "host_s": p.get("host_s"),
                "top_stage": top,
                "decode_%hbm": rl.get("decode_pct_hbm_median", ""),
            }
        )
    if rows:
        click.echo(
            tabulate(rows, headers="keys", tablefmt="rounded_outline")
        )


@cli.command()
@click.argument("ident")
@click.option("-o", "--out", type=click.Path(dir_okay=False),
              help="Write the Chrome trace JSON here (default: stdout)")
@click.option("--json", "as_json", is_flag=True,
              help="Same document, compact (alias for piping)")
def trace(ident: str, out: Optional[str], as_json: bool) -> None:
    """Tail-latency forensics: export one request's end-to-end trace
    (admission -> queue -> prefill -> decode -> flush) or a whole job's
    flight record as Chrome trace-event JSON. Load the file at
    https://ui.perfetto.dev or chrome://tracing. IDENT is a trace id
    (tr-..., e.g. from an alert's exemplar_trace_ids), a request id, or
    a job id (OBSERVABILITY.md "Forensics")."""
    from .telemetry import traceexport

    try:
        doc = get_sdk().get_trace(ident)
    except KeyError as e:
        click.echo(to_colored_text(f"✗ {e}", "fail"))
        raise SystemExit(1)
    except Exception as e:  # noqa: BLE001 — remote 404/conn errors
        click.echo(to_colored_text(f"✗ trace unavailable: {e}", "fail"))
        raise SystemExit(1)
    text = (
        json.dumps(doc, sort_keys=True) + "\n"
        if as_json
        else traceexport.render(doc)
    )
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(text)
        n = len(doc.get("traceEvents") or [])
        click.echo(to_colored_text(
            f"wrote {n} events to {out} — open in ui.perfetto.dev",
            "callout",
        ))
        verdict = (doc.get("otherData") or {}).get("verdict")
        if verdict:
            click.echo(f"verdict: {verdict.get('verdict')}")
            for line in verdict.get("evidence") or []:
                click.echo(f"  - {line}")
    else:
        click.echo(text, nl=False)


@cli.command()
@click.option("--interval", default=2.0, show_default=True,
              help="Seconds between dashboard refreshes")
@click.option("--once", is_flag=True,
              help="Render one frame and exit (no screen clearing)")
@click.option("--json", "as_json", is_flag=True,
              help="Raw /monitor document instead of the dashboard")
def watch(interval: float, once: bool, as_json: bool) -> None:
    """Live SLO dashboard over the engine's monitor (OBSERVABILITY.md
    "Live monitor"): windowed rates and latency percentiles, per-tenant
    attribution, active alerts, and in-flight doctor verdicts.
    Refreshes until interrupted; requires telemetry and the monitor to
    be enabled (SUTRO_TELEMETRY / SUTRO_MONITOR)."""
    sdk = get_sdk()
    while True:
        try:
            doc = sdk.get_monitor()
        except KeyError as e:
            click.echo(to_colored_text(f"✗ {e}", "fail"))
            raise SystemExit(1)
        except Exception as e:  # noqa: BLE001 — remote 404/conn errors
            click.echo(to_colored_text(f"✗ monitor unavailable: {e}",
                                       "fail"))
            raise SystemExit(1)
        if as_json:
            click.echo(json.dumps(doc, indent=2))
        else:
            if not once:
                click.clear()
            _render_watch_frame(doc)
        if once or as_json:
            return
        try:
            time.sleep(max(interval, 0.1))
        except KeyboardInterrupt:
            return


def _render_watch_frame(doc: dict) -> None:
    stats = doc.get("stats") or {}
    rates = stats.get("rates") or {}
    gauges = stats.get("gauges") or {}
    pcts = stats.get("percentiles") or {}
    click.echo(to_colored_text(
        f"sutro watch — tick {doc.get('ticks')} · window "
        f"{stats.get('window_s', 0)}s · interval {doc.get('interval_s')}s"
        + (" · DEGRADED: " + str(doc["degraded"])
           if doc.get("degraded") else ""),
        "callout",
    ))
    row = {
        "rows/s": rates.get("rows_per_s", 0.0),
        "tok/s": rates.get("tokens_per_s", 0.0),
        "quarantine/s": rates.get("quarantined_per_s", 0.0),
        "jobs": gauges.get("jobs_running", 0),
        "interactive": gauges.get("interactive_active", 0),
        "dp fleet": gauges.get("dp_fleet_size", ""),
    }
    ttft, itl = pcts.get("ttft"), pcts.get("itl")
    if ttft:
        row["ttft p50/p99 (s)"] = (
            f"{ttft['p50_s']:.3g}/{ttft.get('p99_s') or 0:.3g}"
        )
    if itl:
        row["itl p50/p99 (s)"] = (
            f"{itl['p50_s']:.3g}/{itl.get('p99_s') or 0:.3g}"
        )
    click.echo(tabulate([row], headers="keys",
                        tablefmt="rounded_outline"))
    alerts = doc.get("alerts") or {}
    active = alerts.get("active") or []
    if active:
        click.echo(to_colored_text(
            f"⚠ {len(active)} alert(s) FIRING", "fail"))
        for a in active:
            click.echo(
                f"  {a['name']} [{a['severity']}] {a['metric']} "
                f"{a['op']} {a['threshold']} (value={a.get('value')})"
            )
    else:
        click.echo(to_colored_text("no alerts firing", "success"))
    events = (alerts.get("events") or [])[-5:]
    if events:
        click.echo("recent transitions:")
        for ev in events:
            click.echo(
                f"  {ev['state']:>8}  {ev['rule']} "
                f"(value={ev.get('value')})"
            )
    verdicts = doc.get("verdicts") or {}
    if verdicts:
        click.echo("live doctor:")
        for jid, v in sorted(verdicts.items()):
            click.echo(
                f"  {jid}: {v.get('verdict')} "
                f"({v.get('spans', 0)} span(s) in window)"
            )
    tenants = stats.get("tenants") or {}
    if tenants:
        trows = [
            {"tenant": t, **{k: int(v) for k, v in sorted(d.items())}}
            for t, d in sorted(tenants.items())
        ]
        click.echo("tenants:")
        click.echo(tabulate(trows, headers="keys",
                            tablefmt="rounded_outline"))


@cli.command()
def quotas() -> None:
    """Show per-priority row/token quotas (reference cli.py:398-416)."""
    rows = get_sdk().get_quotas()
    table = [
        {"priority": i, **q} for i, q in enumerate(rows)
    ]
    click.echo(tabulate(table, headers="keys", tablefmt="rounded_outline"))


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


@cli.group()
def jobs() -> None:
    """Job management."""


def _fmt_dt(value: Optional[str]) -> str:
    if not value:
        return ""
    try:
        dt = datetime.datetime.fromisoformat(value)
        return dt.astimezone().strftime("%Y-%m-%d %H:%M")
    except Exception:
        return str(value)


@jobs.command("list")
@click.option("--limit", default=25, show_default=True)
def jobs_list(limit: int) -> None:
    """List jobs, newest first (reference cli.py:143-201)."""
    records = get_sdk().list_jobs()[:limit]
    if not records:
        click.echo(to_colored_text("No jobs found."))
        return
    rows = [
        {
            "job_id": r.get("job_id"),
            "status": r.get("status"),
            "name": r.get("name") or "",
            "model": r.get("model") or "",
            "rows": r.get("num_rows"),
            "created": _fmt_dt(r.get("datetime_created")),
            "completed": _fmt_dt(r.get("datetime_completed")),
            "in_tok": r.get("input_tokens"),
            "out_tok": r.get("output_tokens"),
            "cost": (
                f"${r['job_cost']:.4f}" if r.get("job_cost") is not None else ""
            ),
        }
        for r in records
    ]
    click.echo(tabulate(rows, headers="keys", tablefmt="rounded_outline"))


@jobs.command("status")
@click.argument("job_id")
def jobs_status(job_id: str) -> None:
    """Job status plus its failure_log — per-row retries/quarantines,
    transient-I/O retries, and terminal failures (FAILURES.md) — and,
    for elastic dp jobs, the fleet view (per-rank membership state,
    requeue/steal counters)."""
    sdk = get_sdk()
    out = sdk.get_job_status(job_id, with_failure_log=True)
    click.echo(out["status"])
    # stage-graph rollup: best-effort decoration, same contract as the
    # fleet view below — a plain job (or an old daemon without stage
    # fields) prints nothing extra
    try:
        rec = sdk._fetch_job(job_id)
        stages_state = rec.get("stages_state") or {}
    except Exception:  # graftlint: disable=silent-except
        stages_state = {}
    if stages_state:
        click.echo(to_colored_text("stages:", "callout"))
        for sname, s in stages_state.items():
            bits = [
                f"  {sname}",
                f"[{s.get('kind', 'map')}]",
                str(s.get("status", "?")),
                f"{s.get('rows_done', 0)}/{s.get('rows_total', 0)} rows",
            ]
            if s.get("quarantined"):
                bits.append(f"{s['quarantined']} quarantined")
            click.echo(" ".join(bits))
    try:
        fleet = sdk.get_job_fleet(job_id)
    # the fleet view is best-effort decoration on the status output: an
    # old daemon without the /job-fleet route must not break `status`
    except Exception:  # graftlint: disable=silent-except
        fleet = None
    if fleet and fleet.get("elastic"):
        rows = fleet.get("rows") or {}
        c = fleet.get("counters") or {}
        live = "live" if fleet.get("live") else "final"
        click.echo(
            to_colored_text(
                f"dp fleet ({live}): {fleet.get('live_ranks', 0)} "
                f"live rank(s) of world {fleet.get('world')}; rows "
                f"{rows.get('done', 0)}/{rows.get('total', 0)} done, "
                f"{rows.get('pending', 0)} pending, "
                f"{rows.get('inflight', 0)} in flight; "
                f"requeued={c.get('requeued_rows', 0)} "
                f"stolen={c.get('stolen_rows', 0)} "
                f"dup_dropped={c.get('duplicate_results_dropped', 0)}",
                "callout",
            )
        )
        for r, v in sorted(
            (fleet.get("ranks") or {}).items(),
            key=lambda kv: int(kv[0]),
        ):
            bits = [f"rank {r}: {v.get('state', '?')}"]
            if v.get("late_join"):
                bits.append("late-join")
            if not v.get("elastic", True):
                bits.append("v1-peer")
            rem = v.get("rows_remaining")
            if rem:
                bits.append(f"{rem} row(s) remaining")
            if v.get("reason"):
                bits.append(str(v["reason"]))
            click.echo("  " + " ".join(bits))
    if out.get("has_telemetry_dump"):
        click.echo(
            to_colored_text(
                "telemetry dump available: "
                f"`sutro telemetry --job {job_id}` for the timeline, "
                f"`sutro doctor {job_id}` for the bottleneck verdict",
                "callout",
            )
        )
    log = out.get("failure_log") or []
    if log:
        shown = log[-20:]
        click.echo(
            to_colored_text(
                f"failure_log ({len(log)} event(s)"
                + (f", last {len(shown)}" if len(shown) < len(log) else "")
                + "):",
                "callout",
            )
        )
        for ev in shown:
            bits = [str(ev.get("ts", "")), str(ev.get("event", "?"))]
            if ev.get("row_id") is not None:
                bits.append(f"row={ev['row_id']}")
            if ev.get("attempt"):
                bits.append(f"attempt={ev['attempt']}")
            if ev.get("site"):
                bits.append(f"site={ev['site']}")
            if ev.get("error"):
                bits.append(str(ev["error"]))
            click.echo("  " + " ".join(bits))


@jobs.command("results")
@click.argument("job_id")
@click.option("--output-path", default=None, help="Write parquet here")
@click.option("--include-inputs", is_flag=True)
def jobs_results(
    job_id: str, output_path: Optional[str], include_inputs: bool
) -> None:
    df = get_sdk().get_job_results(job_id, include_inputs=include_inputs)
    if df is None:
        sys.exit(1)
    if output_path:
        df.to_parquet(output_path)
        click.echo(to_colored_text(f"✔ Wrote {output_path}", "success"))
    else:
        click.echo(df.head(20).to_string())


@jobs.command("cancel")
@click.argument("job_id")
def jobs_cancel(job_id: str) -> None:
    out = get_sdk().cancel_job(job_id)
    click.echo(to_colored_text(f"Status: {out.get('status')}", "callout"))


@jobs.command("resume")
@click.argument("job_id")
def jobs_resume(job_id: str) -> None:
    """Re-queue a failed/cancelled job; completed rows are kept."""
    out = get_sdk().resume_job(job_id)
    if out.get("resumed"):
        click.echo(
            to_colored_text(
                f"✔ Resumed ({out.get('rows_already_done', 0)} rows "
                "already done)",
                "success",
            )
        )
    else:
        click.echo(
            to_colored_text(
                f"Not resumed: {out.get('detail')} "
                f"(status: {out.get('status')})",
                "callout",
            )
        )


@jobs.command("attach")
@click.argument("job_id", required=False)
@click.option("--latest", is_flag=True, help="Attach to the most recent job")
def jobs_attach(job_id: Optional[str], latest: bool) -> None:
    """Re-attach to a running job (reference cli.py:419-435)."""
    sdk = get_sdk()
    if latest or not job_id:
        records = sdk.list_jobs()
        if not records:
            click.echo(to_colored_text("No jobs found.", "fail"))
            sys.exit(1)
        job_id = records[0]["job_id"]
    sdk.attach(job_id)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@cli.group()
def datasets() -> None:
    """Dataset management."""


@datasets.command("create")
def datasets_create() -> None:
    click.echo(get_sdk().create_dataset())


@datasets.command("list")
def datasets_list() -> None:
    ds = get_sdk().list_datasets()
    if not ds:
        click.echo(to_colored_text("No datasets found."))
        return
    rows = [
        {
            "dataset_id": d.get("dataset_id"),
            "files": d.get("num_files"),
            "added": _fmt_dt(d.get("datetime_added")),
            "updated": _fmt_dt(d.get("updated_at")),
            "schema": json.dumps(d.get("schema") or {})[:60],
        }
        for d in ds
    ]
    click.echo(tabulate(rows, headers="keys", tablefmt="rounded_outline"))


@datasets.command("files")
@click.argument("dataset_id")
def datasets_files(dataset_id: str) -> None:
    for name in get_sdk().list_dataset_files(dataset_id):
        click.echo(name)


@datasets.command("upload")
@click.argument("dataset_id")
@click.argument("paths", nargs=-1, required=True)
def datasets_upload(dataset_id: str, paths: tuple) -> None:
    names = get_sdk().upload_to_dataset(dataset_id, list(paths))
    click.echo(
        to_colored_text(f"✔ Uploaded {len(names)} file(s)", "success")
    )


@datasets.command("download")
@click.argument("dataset_id")
@click.option("--output-path", default=".", show_default=True)
@click.option("--file-name", default=None, help="Single file (default: all)")
def datasets_download(
    dataset_id: str, output_path: str, file_name: Optional[str]
) -> None:
    written = get_sdk().download_from_dataset(
        dataset_id, file_names=file_name, output_path=output_path
    )
    for w in written:
        click.echo(w)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


@cli.group()
def cache() -> None:
    """Local job-results cache (reference cli.py:363-381)."""


@cache.command("show")
def cache_show() -> None:
    rows = get_sdk().show_job_results_cache()
    if not rows:
        click.echo(to_colored_text("Cache is empty."))
        return
    click.echo(tabulate(rows, headers="keys", tablefmt="rounded_outline"))


@cache.command("clear")
def cache_clear() -> None:
    n = get_sdk().clear_job_results_cache()
    click.echo(to_colored_text(f"✔ Cleared {n} cached result file(s)", "success"))


# ---------------------------------------------------------------------------
# engine (device and model info)
# ---------------------------------------------------------------------------


@cli.group()
def engine() -> None:
    """Local engine info."""


@engine.command("info")
def engine_info() -> None:
    import torch

    from .engine.config import load_engine_config

    if torch.cuda.is_available():
        backend = "cuda"
        devices = [
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())
        ]
    else:
        backend, devices = "cpu", ["cpu"]
    ecfg = load_engine_config()
    click.echo(f"backend: {backend}")
    click.echo(f"devices: {devices}")
    dp, pp, sp, ep, tp = ecfg.resolved_mesh(len(devices))
    click.echo(f"mesh: dp={dp} pp={pp} sp={sp} ep={ep} tp={tp}")
    click.echo(
        f"kv: page_size={ecfg.kv_page_size} max_pages_per_seq="
        f"{ecfg.max_pages_per_seq} decode_batch={ecfg.decode_batch_size}"
    )


@engine.command("models")
def engine_models() -> None:
    from .common import MODEL_CATALOG
    from .models.configs import MODEL_CONFIGS

    rows = []
    for name, meta in MODEL_CATALOG.items():
        cfg = MODEL_CONFIGS[meta["engine_key"]]
        rows.append(
            {
                "model": name,
                "layers": cfg.num_layers,
                "hidden": cfg.hidden_size,
                "experts": cfg.moe_experts or "",
                "type": "embed" if meta["embedding"] else (
                    "thinking" if meta["thinking"] else "lm"
                ),
            }
        )
    click.echo(tabulate(rows, headers="keys", tablefmt="rounded_outline"))


if __name__ == "__main__":
    cli()
