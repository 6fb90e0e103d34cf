from .text import Text, get_elem_id
from .table import Table, WriteableTable, instantiate_table

__all__ = ['Text', 'Table', 'WriteableTable', 'get_elem_id', 'instantiate_table']
