"""RAR core of the port: decision core, guide store, FM tiers, the
sequential and microbatched controllers and the shadow queue."""
