"""Paper contributions: NeuroForge (DSE), NeuroMorph (elastic/morph)."""
