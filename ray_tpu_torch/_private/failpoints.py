"""Deterministic fault injection for the chaos harness.

Reference analogue: the C++ core's testing fault-injection flags
(``RAY_testing_asio_delay_us`` and the chaos node-killer of
``_private/test_utils.py``) — but *site-addressed*: a failpoint fires at
a **named protocol point** (a ring hop, a hierarchical phase boundary,
an actor-call entry), so a chaos test kills a rank at an exact position
inside a schedule instead of racing a sleep against the wall clock.

Activation is either the ``RTPU_FAILPOINTS`` environment variable
(parsed at import — covers whole node processes and the workers they
spawn) or :func:`activate` at runtime (a test arms one specific actor
process through an actor method).

Spec grammar (entries joined by ``;``)::

    entry  := site "=" action ["@" guard {"&" guard}] ["!once"]
    action := "kill" | "exit" | "raise" | "sleep:<seconds>"
    guard  := key "=" value     # string-compared against fp() ctx

Examples::

    coll.op.begin=kill@seq=2            # SIGKILL self entering seq-2 op
    coll.hier.phase=kill@phase=up&chunk=1!once
    actor.call.begin=sleep:0.5@method=train_step

Actions: ``kill`` SIGKILLs the current process (the chaos default — the
runtime must recover from an instantaneous death, not a clean exit);
``exit`` is ``os._exit(1)``; ``raise`` raises :class:`FailpointError`;
``sleep:<s>`` delays the site (straggler injection). ``!once`` disarms
the entry after its first firing.

Every ``fp(<site>)`` call site must name a site registered in
``_SITES`` — linted both directions by ``scripts/check_concurrency.py``
(rule g), exactly like config knobs: an unregistered site string is a
typo waiting to never fire.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, List, Optional

# Registered sites: the only strings fp() may be called with. Keep the
# comment naming where each is planted — the lint enforces >= 1 caller.
_SITES = (
    "coll.op.begin",        # collective.py _run_op: one public op starts
    "coll.ring.rs_hop",     # collective.py ring reduce-scatter: per hop
    "coll.hier.phase",      # collective.py hierarchical allreduce phases
    "coll.reform.join",     # collective.py: entering a reform round
    "actor.call.begin",     # worker.py: an actor method is about to run
    "worker.task.begin",    # worker.py: a plain task is about to run
)


class FailpointError(RuntimeError):
    """Raised by the ``raise`` action."""


class _Entry:
    __slots__ = ("site", "action", "arg", "guards", "once", "spent")

    def __init__(self, site: str, action: str, arg: Optional[float],
                 guards: Dict[str, str], once: bool):
        self.site = site
        self.action = action
        self.arg = arg
        self.guards = guards
        self.once = once
        self.spent = False

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if self.spent:
            return False
        for k, v in self.guards.items():
            if str(ctx.get(k)) != v:
                return False
        return True


# Module state: written only by activate()/deactivate(); fp() reads a
# local snapshot, so no lock is needed (an entry list swap is atomic).
_entries: List[_Entry] = []


def parse(spec: str) -> List[_Entry]:
    """Parse one spec string; raises ValueError on malformed entries or
    unregistered site names (a typo must fail loudly at arm time, not
    silently never fire)."""
    out: List[_Entry] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        once = raw.endswith("!once")
        if once:
            raw = raw[:-len("!once")]
        if "=" not in raw:
            raise ValueError(f"failpoint entry {raw!r}: expected "
                             "site=action[@k=v&...][!once]")
        site, rest = raw.split("=", 1)
        site = site.strip()
        if site not in _SITES:
            raise ValueError(
                f"failpoint site {site!r} is not registered in "
                f"failpoints._SITES {sorted(_SITES)}")
        action_part, _, guard_part = rest.partition("@")
        action, _, argstr = action_part.strip().partition(":")
        if action not in ("kill", "exit", "raise", "sleep"):
            raise ValueError(f"failpoint action {action!r}: expected "
                             "kill | exit | raise | sleep:<seconds>")
        arg = None
        if action == "sleep":
            try:
                arg = float(argstr or "0.1")
            except ValueError:
                raise ValueError(
                    f"failpoint sleep arg {argstr!r} is not a number"
                ) from None
        guards: Dict[str, str] = {}
        if guard_part:
            for g in guard_part.split("&"):
                if "=" not in g:
                    raise ValueError(
                        f"failpoint guard {g!r}: expected key=value")
                k, v = g.split("=", 1)
                guards[k.strip()] = v.strip()
        out.append(_Entry(site, action, arg, guards, once))
    return out


def activate(spec: str) -> int:
    """Arm failpoints in THIS process from a spec string; returns the
    number of armed entries. Replaces any previously-armed set."""
    global _entries
    _entries = parse(spec)
    return len(_entries)


def deactivate() -> None:
    global _entries
    _entries = []


def active() -> bool:
    return bool(_entries)


def fp(site: str, **ctx: Any) -> None:
    """One named protocol point. No-op (one list check) unless an armed
    entry's site and guards match the call context."""
    entries = _entries
    if not entries:
        return
    for ent in entries:
        if ent.site != site or not ent.matches(ctx):
            continue
        if ent.once:
            ent.spent = True
        if ent.action == "kill":
            # an instantaneous death, exactly like the OOM killer / a
            # crashed host: no atexit, no socket FIN from our side
            os.kill(os.getpid(), signal.SIGKILL)
        elif ent.action == "exit":
            os._exit(1)
        elif ent.action == "raise":
            raise FailpointError(f"failpoint {site} fired (ctx={ctx})")
        elif ent.action == "sleep":
            time.sleep(ent.arg or 0.0)


_env_spec = os.environ.get("RTPU_FAILPOINTS")
if _env_spec:
    activate(_env_spec)
