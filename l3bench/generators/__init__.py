"""Traffic generators, one a kind of mix: ``generators/<kind>.py`` reads
every ``traffic/<mix>.json`` whose ``kind`` is its name."""
