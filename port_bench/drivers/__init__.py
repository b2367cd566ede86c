"""One driver a kind of entry that a window drives; the configuration's
``driver`` key names the file."""
