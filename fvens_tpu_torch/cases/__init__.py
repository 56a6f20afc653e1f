from .casesolvers import (SteadyFlowCase, UnsteadyFlowCase, build_space,
                          initial_state)

__all__ = ["SteadyFlowCase", "UnsteadyFlowCase", "initial_state",
           "build_space"]
