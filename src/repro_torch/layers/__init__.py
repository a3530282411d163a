"""Dense GQA layers of the port (the counterpart of ``repro.layers``)."""
