"""The general generators, one per kind of traffic: each reads a traffic
file's parameters, sets the program up for a configuration, drives the
measured window and checks what it produced."""
