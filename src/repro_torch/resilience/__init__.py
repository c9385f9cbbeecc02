"""Fault-tolerant ensemble runtime: injection, detection, recovery.

The port of ``repro.resilience``. Public surface:

  faults   FaultPlan / FaultSpec / FaultState: seeded declarative fault
           schedules; install_chaos_impls() registers chaos+<base>
           transport wrappers; InjectedFault and friends.
  detect   DeadlineDetector: cost-model (or self-calibrated) deadline
           checks on launch walls.
  engine   run_resilient(): the host-stepped launch loop with transport
           retry, launch replay, act-mask member eviction, re-admission,
           and straggler flagging; RecoveryPolicy / ResilientResult.

Entry points: ``runtime.execute_ensemble_resilient(ensemble, plan=...)``
(core.runtimes.base), or call :func:`run_resilient` directly.
"""
from repro_torch.resilience.detect import (  # noqa: F401
    DEFAULT_DEADLINE_FACTOR,
    DeadlineDetector,
    Detection,
)
from repro_torch.resilience.engine import (  # noqa: F401
    FaultEvent,
    READMIT_SEED_OFFSET,
    RecoveryPolicy,
    ResilientResult,
    backoff_delay_s,
    run_resilient,
)
from repro_torch.resilience.faults import (  # noqa: F401
    CHAOS_IMPL_PREFIX,
    FAULT_KINDS,
    FAULT_LAUNCH,
    FAULT_MEMBER,
    FAULT_STRAGGLER,
    FAULT_TRANSPORT,
    FaultPlan,
    FaultSpec,
    FaultState,
    InjectedFault,
    LaunchFault,
    MemberFault,
    TransientTransportFault,
    UnrecoverableFault,
    armed,
    armed_state,
    install_chaos_impls,
    transport_site,
)
