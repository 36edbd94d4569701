"""Unified store API of the port: the :class:`MappingStore` protocol,
the plan-based streaming query layer, cross-store federation, and the
``repro_torch.open`` / ``repro_torch.build`` entrypoints — what
``repro.api`` exports.

Store implementations (``repro_torch.core``, ``repro_torch.cluster``,
``repro_torch.baselines``) subclass
:class:`MappingStore`; this package never imports them at module level
(they import us), so the dependency direction stays acyclic.
"""

from repro_torch.api.cache import PlanCache, plan_fingerprint  # noqa: F401
from repro_torch.api.entry import build, open  # noqa: F401,A004
from repro_torch.api.executor import (  # noqa: F401
    MorselResult,
    execute_plan,
    execute_plan_staged,
    execute_plans,
    next_morsel_rows,
    stream_plan,
)
from repro_torch.api.federated import FederatedStore  # noqa: F401
from repro_torch.api.plan import (  # noqa: F401
    AggregateResult,
    AggSpec,
    ExplainStats,
    JoinSpec,
    OperatorStats,
    Predicate,
    QueryPlan,
    QueryResult,
    evaluate_predicates,
)
from repro_torch.api.protocol import CONFORMANCE_METHODS, MappingStore  # noqa: F401
from repro_torch.api.query import Query  # noqa: F401
