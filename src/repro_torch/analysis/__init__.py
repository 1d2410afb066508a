"""Analysis of the port's runs (counterpart of ``repro.analysis``): the
dry-run planner's roofline terms (:mod:`.roofline`)."""
