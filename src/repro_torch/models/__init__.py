"""Model stack of the port: layers, attention, model assembly."""
