"""Fleet serving: segment routing (``router``).  Fleet training is
ROADMAP A17."""
