"""Drivers of the traffic mixes: a traffic file names its driver, whose
``run(cell, ...)`` sets the program up, drives the measured window and
hands back what the check and the metric readers need."""
