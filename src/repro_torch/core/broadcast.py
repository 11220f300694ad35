"""Reconfiguration Broadcast (RB) — paper §III-A module 4.

Disseminates a new (split, placement) configuration to the affected node
agents *consistently*: a versioned two-phase rollout (PREPARE → COMMIT) so a
node crash mid-rollout can never leave the fleet executing two different
partition maps.  Node agents are in-process objects here (the container has no
cluster), but the interface is controller-shaped: ``prepare``/``commit``/
``abort`` mirror what a Kubernetes custom-controller reconcile loop would do.

Hardened path: delivery is at-least-once over a lossy transport —
``RolloutPolicy`` bounds per-RPC retries with exponential backoff and
deterministic jitter, agents dedupe duplicate/out-of-order deliveries by
version (so a retry after a timeout-but-delivered RPC is a no-op), and every
config carries the issuing controller's **epoch**: agents reject configs from
a lower epoch than the highest they have seen, so a zombie pre-restart
controller can never commit over its recovered successor
(``claim_epoch`` is the successor's fence).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol

__all__ = [
    "PartitionConfig", "NodeAgent", "InProcessAgent", "RolloutPolicy",
    "ReconfigurationBroadcast",
]

_MASK64 = (1 << 64) - 1


def _mix(*xs: int) -> int:
    """Stable 64-bit hash of a tuple of ints (splitmix64-flavoured).

    Used for deterministic jitter and fault draws: the value depends only on
    the inputs, never on interpreter hash seeds or call order.
    """
    h = 0x9E3779B97F4A7C15
    for x in xs:
        z = (int(x) + 0x9E3779B97F4A7C15 + h) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = z ^ (z >> 31)
    return h


def _unit(*xs: int) -> float:
    """Deterministic uniform in [0, 1) from a tuple of ints."""
    return _mix(*xs) / float(1 << 64)


@dataclass(frozen=True)
class PartitionConfig:
    """One immutable deployment config: version + split + placement.

    ``session`` scopes the config to one tenant of a multi-session fleet
    (agents keep one staged/active slot PER session); ``None`` is the
    single-session/sessionless scope used by the paper's Alg. 1 loop.
    ``epoch`` is the issuing controller's fencing token (see module doc).
    """

    version: int
    boundaries: tuple[int, ...]
    assignment: tuple[int, ...]
    reason: str = ""
    issued_at: float = 0.0
    session: int | None = None
    epoch: int = 0

    def segments_for(self, node: int) -> list[tuple[int, int]]:
        return [
            (self.boundaries[j], self.boundaries[j + 1])
            for j, n in enumerate(self.assignment)
            if n == node
        ]


class NodeAgent(Protocol):
    node_id: int

    def prepare(self, cfg: PartitionConfig) -> bool: ...
    def commit(self, version: int) -> bool: ...
    def abort(self, version: int) -> None: ...


@dataclass(frozen=True)
class RolloutPolicy:
    """Bounded-retry delivery policy for one prepare/commit RPC.

    An RPC that fails (or succeeds but takes longer than ``rpc_timeout_s`` —
    the ambiguous timeout-but-delivered case, absorbed by agent-side
    idempotency) is retried up to ``max_attempts`` times total, backing off
    ``backoff_base_s · backoff_mult^k`` with deterministic jitter drawn from
    (version, node, attempt) so seed-paired benchmark arms stay comparable.
    Backoff is accounted, not slept: in-process rollouts are instantaneous,
    the budget shows up in ``ReconfigurationBroadcast.stats['backoff_s']``.
    """

    max_attempts: int = 3
    rpc_timeout_s: float = 0.2
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    jitter_frac: float = 0.25

    def backoff_s(self, version: int, node_id: int, attempt: int) -> float:
        base = self.backoff_base_s * self.backoff_mult ** (attempt - 1)
        return base * (1.0 + self.jitter_frac * _unit(version, node_id, attempt))


@dataclass
class InProcessAgent:
    """Reference agent: stages weights for its segments, then swaps atomically.

    Staged and active configs are keyed by the config's ``session`` scope,
    so interleaved rollouts for two tenants can never clobber each other's
    state (a single shared slot used to lose session A's config the moment
    session B rolled out).  ``active``/``staged`` remain as properties for
    sessionless callers: the most recently committed/staged config.

    Delivery is idempotent and version-deduped: a duplicate ``prepare`` of a
    staged/active version is acknowledged without re-staging, a duplicate
    ``commit`` of an already-active version is acknowledged without a second
    history entry, and an out-of-order *older* version never regresses a
    newer staged/active config.  ``epoch`` fences zombie controllers:
    deliveries carrying an epoch below the highest seen are rejected
    (counted in ``fenced``).
    """

    node_id: int
    fail_prepare: bool = False      # fault-injection hooks for tests
    fail_commit: bool = False
    epoch: int = 0                  # highest controller epoch seen
    fenced: int = 0                 # rejected stale-epoch deliveries
    active_by: dict = field(default_factory=dict)   # session → committed cfg
    staged_by: dict = field(default_factory=dict)   # session → staged cfg
    # session → version of the last committed RELEASE (a config whose
    # assignment no longer includes this node): the tombstone that makes
    # duplicate release commits idempotent
    released: dict = field(default_factory=dict)
    history: list[int] = field(default_factory=list)

    @property
    def active(self) -> PartitionConfig | None:
        return max(self.active_by.values(), key=lambda c: c.version,
                   default=None)

    @property
    def staged(self) -> PartitionConfig | None:
        return max(self.staged_by.values(), key=lambda c: c.version,
                   default=None)

    def active_for(self, session: int | None) -> PartitionConfig | None:
        return self.active_by.get(session)

    def prepare(self, cfg: PartitionConfig) -> bool:
        if self.fail_prepare:
            return False
        if cfg.epoch < self.epoch:
            self.fenced += 1
            return False
        self.epoch = cfg.epoch
        cur = self.active_by.get(cfg.session)
        if cur is not None and cfg.version <= cur.version:
            # duplicate (retry of an already-committed rollout) or stale
            # out-of-order delivery: acknowledge, never regress
            return True
        rel = self.released.get(cfg.session)
        if rel is not None and cfg.version <= rel:
            return True     # replay of an already-released handoff
        st = self.staged_by.get(cfg.session)
        if st is not None and cfg.version <= st.version:
            return True
        self.staged_by[cfg.session] = cfg
        return True

    def commit(self, version: int) -> bool:
        """Versions are globally unique, so the protocol signature stays
        ``commit(version)`` — the agent finds the matching staged scope."""
        if self.fail_commit:
            return False
        for cfg in self.active_by.values():
            if cfg.version == version:
                return True     # duplicate commit delivery: no-op ack
        if version in self.released.values():
            return True         # duplicate release delivery: no-op ack
        for scope, cfg in list(self.staged_by.items()):
            if cfg.version == version:
                if cfg.epoch < self.epoch:
                    self.fenced += 1
                    return False
                cur = self.active_by.get(scope)
                if cur is not None and version < cur.version:
                    del self.staged_by[scope]   # stale: newer already active
                    return True
                del self.staged_by[scope]
                if self.node_id not in cfg.assignment:
                    # atomic handoff: the new placement moved this scope off
                    # this node — commit is a RELEASE, not an activation (no
                    # history entry; history records activations only)
                    self.active_by.pop(scope, None)
                    self.released[scope] = version
                    return True
                self.active_by[scope] = cfg
                self.history.append(version)
                return True
        return False

    def abort(self, version: int) -> None:
        for scope in [s for s, c in self.staged_by.items()
                      if c.version == version]:
            del self.staged_by[scope]


def _unwrap(agent):
    """Peel transport wrappers down to the stateful agent."""
    while hasattr(agent, "inner"):
        agent = agent.inner
    return agent


def _new_stats() -> dict:
    return {"rollouts": 0, "commits": 0, "aborts": 0, "retries": 0,
            "rpc_failures": 0, "backoff_s": 0.0, "fenced_rollouts": 0}


@dataclass
class ReconfigurationBroadcast:
    agents: list[InProcessAgent]
    _version: int = 0
    epoch: int = 0
    policy: RolloutPolicy = field(default_factory=RolloutPolicy)
    log: list[tuple[str, PartitionConfig]] = field(default_factory=list)
    stats: dict = field(default_factory=_new_stats)

    def next_version(self) -> int:
        self._version += 1
        return self._version

    def claim_epoch(self) -> int:
        """Fence all prior controllers: bump every agent past the highest
        epoch seen anywhere.  A recovered controller calls this once at
        startup; the pre-crash zombie's configs then carry a stale epoch and
        are rejected at prepare."""
        e = max([self.epoch] + [getattr(a, "epoch", 0) for a in self.agents]) + 1
        self.epoch = e
        for a in self.agents:
            _unwrap(a).epoch = e
        return e

    def _deliver(self, agent, version: int, fn) -> bool:
        """At-least-once delivery of one RPC under the retry policy."""
        pol = self.policy
        for attempt in range(1, max(1, pol.max_attempts) + 1):
            ok = fn()
            delay = getattr(agent, "last_delay_s", 0.0)
            if ok and delay <= pol.rpc_timeout_s:
                if attempt > 1:
                    self.stats["retries"] += attempt - 1
                return True
            self.stats["rpc_failures"] += 1
            if attempt < pol.max_attempts:
                self.stats["backoff_s"] += pol.backoff_s(
                    version, getattr(agent, "node_id", 0), attempt)
        self.stats["retries"] += max(0, pol.max_attempts - 1)
        return False

    def rollout(
        self,
        boundaries: tuple[int, ...],
        assignment: tuple[int, ...],
        reason: str = "",
        now: float | None = None,
        session: int | None = None,
    ) -> PartitionConfig | None:
        """Two-phase rollout; returns the committed config or None on abort."""
        cfg = PartitionConfig(
            version=self.next_version(),
            boundaries=boundaries,
            assignment=assignment,
            reason=reason,
            issued_at=time.monotonic() if now is None else now,
            session=session,
            epoch=self.epoch,
        )
        self.stats["rollouts"] += 1
        # the affected set is the UNION of the new placement and the current
        # scope holders: an agent the session migrates OFF rides the same
        # two-phase protocol and commits a release — so a handoff is atomic
        # (all-new-active + old-released, or a full rollback), and no agent
        # is left serving a stale active config forever
        nodes = set(assignment)
        affected = [a for a in self.agents
                    if a.node_id in nodes
                    or a.active_by.get(cfg.session) is not None]
        # phase 1: PREPARE — all affected agents must stage the config
        prepared: list[InProcessAgent] = []
        for agent in affected:
            if self._deliver(agent, cfg.version, lambda: agent.prepare(cfg)):
                prepared.append(agent)
            else:
                # abort ALL affected agents (idempotent on never-staged
                # ones): a timed-out prepare may still have staged
                for p in affected:
                    p.abort(cfg.version)
                self.log.append(("abort", cfg))
                self.stats["aborts"] += 1
                if any(getattr(_unwrap(a), "epoch", 0) > cfg.epoch
                       for a in affected):
                    self.stats["fenced_rollouts"] += 1
                return None
        # phase 2: COMMIT — atomically swap; a commit failure rolls others
        # back to the PREVIOUS active config for this scope (blanking the
        # node instead would leave every already-committed agent executing
        # no config at all — the mid-storm fleet-blackout bug)
        prior = {a.node_id: a.active_by.get(cfg.session) for a in prepared}
        committed: list[InProcessAgent] = []
        for agent in prepared:
            if self._deliver(agent, cfg.version,
                             lambda: agent.commit(cfg.version)):
                committed.append(agent)
            else:
                # roll back EVERY prepared agent, not just the acked ones: a
                # commit that "failed" by timeout may have been delivered and
                # applied (the at-least-once ambiguity) — restoring prior
                # state is idempotent on agents that never applied it
                for c in prepared:
                    inner = _unwrap(c)
                    if inner.history and inner.history[-1] == cfg.version:
                        inner.history.pop()
                    if inner.released.get(cfg.session) == cfg.version:
                        del inner.released[cfg.session]   # undo the handoff
                    if prior[c.node_id] is None:
                        inner.active_by.pop(cfg.session, None)
                    else:
                        inner.active_by[cfg.session] = prior[c.node_id]
                for p in prepared:
                    p.abort(cfg.version)   # incl. the failed agent's stage
                self.log.append(("abort", cfg))
                self.stats["aborts"] += 1
                return None
        self.log.append(("commit", cfg))
        self.stats["commits"] += 1
        return cfg

    @property
    def active_version(self) -> int:
        for kind, cfg in reversed(self.log):
            if kind == "commit":
                return cfg.version
        return 0
