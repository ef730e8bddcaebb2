"""Frequency-remapped table layout and the plain embedding bag."""
