from .steps import (make_decode_step, make_paged_decode_step,
                    make_paged_prefill_step, make_prefill_step)
from .engine import (ModelBackend, Request, ServeEngine, StepCost,
                     SyntheticBackend, poisson_workload, run_static)
