"""Model code of the port (dense family): layers, attention, the
stacked transformer and the serving entry points."""
