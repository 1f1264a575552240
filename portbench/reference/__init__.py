"""The plain reference the benchmark judges the program by.

Plain numpy, written from the IBU format and the semantics of each job; it
imports nothing of the program. It is given the inputs the benchmark made
and works every answer out again from them.
"""
