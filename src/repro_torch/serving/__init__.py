"""Request streams, the arrival-ordered queue and the dynamic batcher
(numpy copies of the reference's ``repro.serving`` modules)."""
