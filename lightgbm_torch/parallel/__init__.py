"""Multi-device training support.  The port has, so far, the part of the
JAX package's ``parallel/elastic.py`` that the computation-integrity
layer needs (``elastic``: failure classification and suspect-device
quarantine); the distributed learners and the elastic recovery ladder
are ROADMAP A16."""
