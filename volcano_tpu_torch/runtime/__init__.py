"""Host-side runtime pieces of the port: the numpy oracle of the allocate
pass (:mod:`.cpu_reference`)."""
