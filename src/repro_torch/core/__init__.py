"""Core ADEL-FL math of the port: Problem-2 cost and solver, straggler
model, policies, Eq. 5 aggregation and wire compression."""
