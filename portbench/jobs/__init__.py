"""One runner per job kind, named by a traffic mix's ``job``."""
