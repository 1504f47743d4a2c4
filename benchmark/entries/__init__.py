"""The entries a traffic file can name: each drives one of the program's
entry points through the window and checks what it produced."""
