"""Drivers of the program's entry points, a module each, chosen by a
traffic mix's `driver`."""
