"""Port of tempo_tpu/modules for the single binary (see each module's
docstring for what waits for a later slice).

Service modules — the roles of the distributed system.

Reference: modules/{distributor,ingester,querier,frontend,compactor,
generator,overrides} (SURVEY.md sections 2.2-2.3). Each module is a
plain object with explicit lifecycle methods; the app wiring
(tempo_tpu_torch.app) composes them single-binary style or per-role, with the
ring deciding data placement exactly like the reference's dskit ring.
"""
