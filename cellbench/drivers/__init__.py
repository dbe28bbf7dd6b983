"""One driver per kind of traffic: it builds the system under test from
a configuration, feeds it the traffic, times the window and reads what
``correct`` is decided from.  A traffic file names its driver."""
