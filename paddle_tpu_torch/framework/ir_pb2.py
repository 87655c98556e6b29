# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ir.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08ir.proto\x12\rpaddle_tpu.ir\"\x15\n\x04Ints\x12\r\n\x01v\x18\x01 \x03(\x03\x42\x02\x10\x01\"\x17\n\x06\x46loats\x12\r\n\x01v\x18\x01 \x03(\x01\x42\x02\x10\x01\"\x14\n\x07Strings\x12\t\n\x01v\x18\x01 \x03(\t\"\x16\n\x05\x42ools\x12\r\n\x01v\x18\x01 \x03(\x08\x42\x02\x10\x01\"\x9b\x02\n\x04\x41ttr\x12\x0b\n\x01i\x18\x01 \x01(\x03H\x00\x12\x0b\n\x01\x66\x18\x02 \x01(\x01H\x00\x12\x0b\n\x01s\x18\x03 \x01(\tH\x00\x12\x0b\n\x01\x62\x18\x04 \x01(\x08H\x00\x12#\n\x04ints\x18\x05 \x01(\x0b\x32\x13.paddle_tpu.ir.IntsH\x00\x12\'\n\x06\x66loats\x18\x06 \x01(\x0b\x32\x15.paddle_tpu.ir.FloatsH\x00\x12)\n\x07strings\x18\x07 \x01(\x0b\x32\x16.paddle_tpu.ir.StringsH\x00\x12%\n\x05\x62ools\x18\x08 \x01(\x0b\x32\x14.paddle_tpu.ir.BoolsH\x00\x12\x0f\n\x05\x62lock\x18\t \x01(\x03H\x00\x12%\n\x06\x62locks\x18\n \x01(\x0b\x32\x13.paddle_tpu.ir.IntsH\x00\x42\x07\n\x05value\"\"\n\x04Slot\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04\x61rgs\x18\x02 \x03(\t\"\xe6\x01\n\x05OpDef\x12\x0c\n\x04type\x18\x01 \x01(\t\x12#\n\x06inputs\x18\x02 \x03(\x0b\x32\x13.paddle_tpu.ir.Slot\x12$\n\x07outputs\x18\x03 \x03(\x0b\x32\x13.paddle_tpu.ir.Slot\x12.\n\x05\x61ttrs\x18\x04 \x03(\x0b\x32\x1f.paddle_tpu.ir.OpDef.AttrsEntry\x12\x11\n\tcallstack\x18\x05 \x03(\t\x1a\x41\n\nAttrsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.paddle_tpu.ir.Attr:\x02\x38\x01\"\xb2\x01\n\x06VarDef\x12\x0c\n\x04name\x18\x01 \x01(\t\x12$\n\x04kind\x18\x02 \x01(\x0e\x32\x16.paddle_tpu.ir.VarKind\x12#\n\x05\x64type\x18\x03 \x01(\x0e\x32\x14.paddle_tpu.ir.DType\x12\r\n\x05shape\x18\x04 \x03(\x03\x12\x13\n\x0bpersistable\x18\x05 \x01(\x08\x12\x15\n\rstop_gradient\x18\x06 \x01(\x08\x12\x14\n\x0cis_parameter\x18\x07 \x01(\x08\"s\n\x08\x42lockDef\x12\x0b\n\x03idx\x18\x01 \x01(\x05\x12\x12\n\nparent_idx\x18\x02 \x01(\x05\x12#\n\x04vars\x18\x03 \x03(\x0b\x32\x15.paddle_tpu.ir.VarDef\x12!\n\x03ops\x18\x04 \x03(\x0b\x32\x14.paddle_tpu.ir.OpDef\"\x84\x01\n\nProgramDef\x12\'\n\x06\x62locks\x18\x01 \x03(\x0b\x32\x17.paddle_tpu.ir.BlockDef\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12\x13\n\x0brandom_seed\x18\x03 \x01(\x03\x12\x12\n\nfeed_names\x18\x04 \x03(\t\x12\x13\n\x0b\x66\x65tch_names\x18\x05 \x03(\t*\xf1\x01\n\x05\x44Type\x12\x10\n\x0c\x44T_UNDEFINED\x10\x00\x12\x0b\n\x07\x44T_FP32\x10\x01\x12\x0b\n\x07\x44T_FP64\x10\x02\x12\x0b\n\x07\x44T_FP16\x10\x03\x12\x0b\n\x07\x44T_BF16\x10\x04\x12\x0b\n\x07\x44T_INT8\x10\x05\x12\x0c\n\x08\x44T_INT16\x10\x06\x12\x0c\n\x08\x44T_INT32\x10\x07\x12\x0c\n\x08\x44T_INT64\x10\x08\x12\x0c\n\x08\x44T_UINT8\x10\t\x12\x0b\n\x07\x44T_BOOL\x10\n\x12\x10\n\x0c\x44T_COMPLEX64\x10\x0b\x12\x11\n\rDT_COMPLEX128\x10\x0c\x12\r\n\tDT_UINT16\x10\r\x12\r\n\tDT_UINT32\x10\x0e\x12\r\n\tDT_UINT64\x10\x0f*\\\n\x07VarKind\x12\x0c\n\x08VK_DENSE\x10\x00\x12\x14\n\x10VK_SELECTED_ROWS\x10\x01\x12\r\n\tVK_READER\x10\x02\x12\x12\n\x0eVK_STEP_SCOPES\x10\x03\x12\n\n\x06VK_RAW\x10\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ir_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _INTS.fields_by_name['v']._options = None
  _INTS.fields_by_name['v']._serialized_options = b'\020\001'
  _FLOATS.fields_by_name['v']._options = None
  _FLOATS.fields_by_name['v']._serialized_options = b'\020\001'
  _BOOLS.fields_by_name['v']._options = None
  _BOOLS.fields_by_name['v']._serialized_options = b'\020\001'
  _OPDEF_ATTRSENTRY._options = None
  _OPDEF_ATTRSENTRY._serialized_options = b'8\001'
  _DTYPE._serialized_start=1110
  _DTYPE._serialized_end=1351
  _VARKIND._serialized_start=1353
  _VARKIND._serialized_end=1445
  _INTS._serialized_start=27
  _INTS._serialized_end=48
  _FLOATS._serialized_start=50
  _FLOATS._serialized_end=73
  _STRINGS._serialized_start=75
  _STRINGS._serialized_end=95
  _BOOLS._serialized_start=97
  _BOOLS._serialized_end=119
  _ATTR._serialized_start=122
  _ATTR._serialized_end=405
  _SLOT._serialized_start=407
  _SLOT._serialized_end=441
  _OPDEF._serialized_start=444
  _OPDEF._serialized_end=674
  _OPDEF_ATTRSENTRY._serialized_start=609
  _OPDEF_ATTRSENTRY._serialized_end=674
  _VARDEF._serialized_start=677
  _VARDEF._serialized_end=855
  _BLOCKDEF._serialized_start=857
  _BLOCKDEF._serialized_end=972
  _PROGRAMDEF._serialized_start=975
  _PROGRAMDEF._serialized_end=1107
# @@protoc_insertion_point(module_scope)
