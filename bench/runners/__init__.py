"""One runner per kind of traffic, named by the traffic file's ``runner``."""
